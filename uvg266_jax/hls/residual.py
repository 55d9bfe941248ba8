"""Residual coefficient coding (residual_coding syntax), encoder + decoder.

Behavioral parity with the reference regular residual coding path:
- uvg_encode_coeff_nxn_generic
  (/root/reference/src/strategies/generic/encode_coding_tree-generic.c:54-325)
- uvg_encode_last_significant_xy (/root/reference/src/encode_coding_tree.c:415)
- context derivations uvg_context_get_sig_coeff_group / _sig_ctx_idx_abs /
  uvg_abs_sum (/root/reference/src/context.c:647-877)

The decoder mirrors the VVC spec parsing process for residual_coding() and is
the conformance oracle for the encoder (asserted in tests and in the e2e
bitstream round-trip).
"""
from __future__ import annotations

import numpy as np

from ..bitstream.cabac import Cabac, CabacDecoder
from ..bitstream.ctx_tables import OFF
from ..ops.scan import (
    GO_RICE_PARS,
    GROUP_IDX,
    MIN_IN_GROUP,
    cg_scan_table,
    coeff_scan_table,
    log2_sbb_size,
)

LAST_PREFIX_CTX = (0, 0, 0, 3, 6, 10, 15, 21)

# dep-quant state machine packed like the reference (32040 = the VVC QState
# transition table; 0 = stay in state 0 when dep-quant is off)
DQ_TRANSITION = 32040


def _log2(x: int) -> int:
    return x.bit_length() - 1


def encode_last_sig_xy(cabac: Cabac, last_x: int, last_y: int,
                       w: int, h: int, is_chroma: bool) -> None:
    """last_sig_coeff_{x,y}_{prefix,suffix} (encode_coding_tree.c:415-470)."""
    lw, lh = _log2(w), _log2(h)
    off_x = 0 if is_chroma else LAST_PREFIX_CTX[lw]
    off_y = 0 if is_chroma else LAST_PREFIX_CTX[lh]
    shift_x = min(2, max(0, w >> 3)) if is_chroma else (lw + 1) >> 2
    shift_y = min(2, max(0, h >> 3)) if is_chroma else (lh + 1) >> 2
    base_x = OFF["last_x_chroma"] if is_chroma else OFF["last_x_luma"]
    base_y = OFF["last_y_chroma"] if is_chroma else OFF["last_y_luma"]

    gx = int(GROUP_IDX[last_x])
    gy = int(GROUP_IDX[last_y])

    for i in range(gx):
        cabac.encode_bin(base_x + off_x + (i >> shift_x), 1)
    if gx < int(GROUP_IDX[min(32, w) - 1]):
        cabac.encode_bin(base_x + off_x + (gx >> shift_x), 0)
    for i in range(gy):
        cabac.encode_bin(base_y + off_y + (i >> shift_y), 1)
    if gy < int(GROUP_IDX[min(32, h) - 1]):
        cabac.encode_bin(base_y + off_y + (gy >> shift_y), 0)
    if gx > 3:
        cabac.encode_bins_ep(last_x - int(MIN_IN_GROUP[gx]), (gx - 2) >> 1)
    if gy > 3:
        cabac.encode_bins_ep(last_y - int(MIN_IN_GROUP[gy]), (gy - 2) >> 1)


def decode_last_sig_xy(dec: CabacDecoder, w: int, h: int,
                       is_chroma: bool) -> tuple[int, int]:
    lw, lh = _log2(w), _log2(h)
    off_x = 0 if is_chroma else LAST_PREFIX_CTX[lw]
    off_y = 0 if is_chroma else LAST_PREFIX_CTX[lh]
    shift_x = min(2, max(0, w >> 3)) if is_chroma else (lw + 1) >> 2
    shift_y = min(2, max(0, h >> 3)) if is_chroma else (lh + 1) >> 2
    base_x = OFF["last_x_chroma"] if is_chroma else OFF["last_x_luma"]
    base_y = OFF["last_y_chroma"] if is_chroma else OFF["last_y_luma"]

    gx = 0
    while gx < int(GROUP_IDX[min(32, w) - 1]) and dec.decode_bin(base_x + off_x + (gx >> shift_x)):
        gx += 1
    gy = 0
    while gy < int(GROUP_IDX[min(32, h) - 1]) and dec.decode_bin(base_y + off_y + (gy >> shift_y)):
        gy += 1
    last_x = int(MIN_IN_GROUP[gx])
    if gx > 3:
        last_x += dec.decode_bins_ep((gx - 2) >> 1)
    last_y = int(MIN_IN_GROUP[gy])
    if gy > 3:
        last_y += dec.decode_bins_ep((gy - 2) >> 1)
    return last_x, last_y


def _sig_ctx_idx_abs(flat: np.ndarray, pos_x: int, pos_y: int, w: int, h: int,
                     is_luma: bool) -> tuple[int, int, int]:
    """Sig-flag context + (diag, temp_sum) for the gtx/par context offset
    (context.c:688-727)."""
    base = pos_y * w + pos_x
    diag = pos_x + pos_y
    num_pos = 0
    sum_abs = 0

    def upd(idx):
        nonlocal num_pos, sum_abs
        a = abs(int(flat[idx]))
        sum_abs += min(4 + (a & 1), a)
        if a:
            num_pos += 1

    if pos_x < w - 1:
        upd(base + 1)
        if pos_x < w - 2:
            upd(base + 2)
        if pos_y < h - 1:
            upd(base + w + 1)
    if pos_y < h - 1:
        upd(base + w)
        if pos_y < h - 2:
            upd(base + 2 * w)

    ctx = min((sum_abs + 1) >> 1, 3) + (4 if diag < 2 else 0)
    if is_luma:
        ctx += 4 if diag < 5 else 0
    return ctx, diag, sum_abs - num_pos


def _gtx_ctx_offset(diag: int, temp_sum: int, is_luma: bool) -> int:
    """ctxOffsetAbs() (encode_coding_tree-generic.c:212-219)."""
    if diag == -1:
        return 0
    off = min(temp_sum, 4) + 1
    if diag == 0:
        off += 15 if is_luma else 5
    elif is_luma:
        off += 10 if diag < 3 else (5 if diag < 10 else 0)
    return off


def _abs_sum(flat: np.ndarray, pos_x: int, pos_y: int, w: int, h: int,
             baselevel: int) -> int:
    """Neighbourhood abs sum for rice-param derivation (context.c:846-877)."""
    base = pos_y * w + pos_x
    s = 0
    if pos_x < w - 1:
        s += abs(int(flat[base + 1]))
        if pos_x < w - 2:
            s += abs(int(flat[base + 2]))
        if pos_y < h - 1:
            s += abs(int(flat[base + w + 1]))
    if pos_y < h - 1:
        s += abs(int(flat[base + w]))
        if pos_y < h - 2:
            s += abs(int(flat[base + 2 * w]))
    return max(min(s - 5 * baselevel, 31), 0)


def _precompute_ctx_maps(coeff: np.ndarray, is_luma: bool):
    """Vectorized per-position context values for the whole TU.

    All of these depend only on the final coefficient values (never on
    CABAC state), so they can be computed in one shot — the same
    factoring the reference's AVX2 strategy uses
    (encode_coding_tree-avx2.c) and the natural batched formulation.

    Returns (sig_ctx, gtx_off, rice4, rice0) int arrays of shape (h, w).
    """
    h, w = coeff.shape
    a = np.abs(coeff.astype(np.int64))
    tmpl = np.minimum(4 + (a & 1), a)
    nz = (a != 0).astype(np.int64)

    def shifted(arr, dy, dx):
        out = np.zeros_like(arr)
        out[:h - dy if dy else h, :w - dx if dx else w] = arr[dy:, dx:]
        return out

    s = (shifted(tmpl, 0, 1) + shifted(tmpl, 0, 2) + shifted(tmpl, 1, 1)
         + shifted(tmpl, 1, 0) + shifted(tmpl, 2, 0))
    num = (shifted(nz, 0, 1) + shifted(nz, 0, 2) + shifted(nz, 1, 1)
           + shifted(nz, 1, 0) + shifted(nz, 2, 0))
    ys, xs = np.mgrid[0:h, 0:w]
    diag = ys + xs
    sig_ctx = np.minimum((s + 1) >> 1, 3) + np.where(diag < 2, 4, 0)
    if is_luma:
        sig_ctx += np.where(diag < 5, 4, 0)

    tsum = s - num
    off = np.minimum(tsum, 4) + 1
    if is_luma:
        off += np.where(diag == 0, 15,
                        np.where(diag < 3, 10, np.where(diag < 10, 5, 0)))
    else:
        off += np.where(diag == 0, 5, 0)

    sa = (shifted(a, 0, 1) + shifted(a, 0, 2) + shifted(a, 1, 1)
          + shifted(a, 1, 0) + shifted(a, 2, 0))
    rice4 = GO_RICE_PARS[np.clip(sa - 20, 0, 31)]
    rice0 = GO_RICE_PARS[np.clip(sa, 0, 31)]
    return sig_ctx.astype(np.int32), off.astype(np.int32), rice4, rice0


def encode_coeff_nxn(cabac: Cabac, coeff: np.ndarray, is_luma: bool,
                     dep_quant: bool = False, signhide: bool = False) -> dict:
    """Encode one TU's quantized coefficients (h, w) with regular RRC.

    Returns constraint info: {'last_scan_pos', 'last_cg_nonzero'} for
    LFNST/MTS signaling decisions (mirrors the cur_cu flag updates at
    encode_coding_tree-generic.c:113-122,310-322).
    """
    h, w = coeff.shape
    lw, lh = _log2(w), _log2(h)
    sw, sh = log2_sbb_size(lw, lh)
    log2_cg_size = sw + sh
    scan = coeff_scan_table(lw, lh)
    scan_cg = cg_scan_table(lw, lh)

    if hasattr(cabac, "coeff_nxn"):
        # native (C++) bulk path — same syntax, one call per TU
        flags = cabac.coeff_nxn(coeff, is_luma, dep_quant, signhide,
                                scan, scan_cg, sw, sh)
        nzs = np.nonzero(coeff.reshape(-1)[scan])[0]
        return {
            "last_scan_pos": int(nzs[-1]),
            "violates_lfnst": bool(flags & 1),
            "lfnst_last_scan_pos": bool(flags & 2),
            "mts_last_scan_pos": bool(flags & 4),
        }

    flat = coeff.reshape(-1).astype(np.int64)

    sig_cg = np.zeros((h >> sh) * (w >> sw), dtype=np.int32)
    nz = np.nonzero(flat[scan])[0]
    scan_pos_last = int(nz[-1])
    for i in nz:
        sig_cg[scan_cg[int(i) >> log2_cg_size]] = 1
    scan_cg_last = scan_pos_last >> log2_cg_size

    pos_last = int(scan[scan_pos_last])
    last_y, last_x = divmod(pos_last, w)
    encode_last_sig_xy(cabac, last_x, last_y, w, h, not is_luma)

    cg_grid_w = w >> sw
    cg_grid_h = h >> sh
    base_cg_ctx = OFF["sig_coeff_group"] + (0 if is_luma else 2)
    sig_base = [OFF["sig_luma_0"], OFF["sig_luma_1"], OFF["sig_luma_2"]] if is_luma \
        else [OFF["sig_chroma_0"], OFF["sig_chroma_1"], OFF["sig_chroma_2"]]
    gt1_base = OFF["gt1_luma"] if is_luma else OFF["gt1_chroma"]
    gt2_base = OFF["gt2_luma"] if is_luma else OFF["gt2_chroma"]
    par_base = OFF["parity_luma"] if is_luma else OFF["parity_chroma"]

    dq_table = DQ_TRANSITION if dep_quant else 0
    quant_state = 0
    reg_bins = (w * h * 28) >> 4

    sig_map, off_map, rice4_map, rice0_map = _precompute_ctx_maps(coeff, is_luma)

    mts_last_scan_pos = False

    for i in range(scan_cg_last, -1, -1):
        cg_blk_pos = int(scan_cg[i])
        cg_pos_y, cg_pos_x = divmod(cg_blk_pos, cg_grid_w)

        if i == scan_cg_last or i == 0:
            sig_cg[cg_blk_pos] = 1
        else:
            right = sig_cg[cg_blk_pos + 1] if cg_pos_x + 1 < cg_grid_w else 0
            lower = sig_cg[cg_blk_pos + cg_grid_w] if cg_pos_y + 1 < cg_grid_h else 0
            ctx = 1 if (right or lower) else 0
            cabac.encode_bin(base_cg_ctx + ctx, int(sig_cg[cg_blk_pos]))

        if not sig_cg[cg_blk_pos]:
            continue

        min_sub_pos = i << log2_cg_size
        first_sig_pos = scan_pos_last if i == scan_cg_last \
            else min_sub_pos + (1 << log2_cg_size) - 1
        next_sig_pos = first_sig_pos
        infer_sig_pos = next_sig_pos if next_sig_pos == scan_pos_last \
            else (min_sub_pos if i != 0 else -1)
        num_non_zero = 0
        last_nz = -1
        first_nz = next_sig_pos
        coeff_signs = 0
        ctx_off = {}

        # first pass: sig / gt1 / par / gt2 (context-coded)
        while next_sig_pos >= min_sub_pos and reg_bins >= 4:
            blk_pos = int(scan[next_sig_pos])
            pos_y, pos_x = divmod(blk_pos, w)
            val = int(flat[blk_pos])
            sig = 1 if val else 0
            if num_non_zero or next_sig_pos != infer_sig_pos:
                ctx_sig = int(sig_map[pos_y, pos_x])
                base = sig_base[max(0, quant_state - 1)]
                cabac.encode_bin(base + (ctx_sig if is_luma else min(ctx_sig, 7)), sig)
                reg_bins -= 1

            if sig:
                off = 0 if next_sig_pos == scan_pos_last \
                    else int(off_map[pos_y, pos_x])
                ctx_off[next_sig_pos] = off
                num_non_zero += 1
                last_nz = max(last_nz, next_sig_pos)
                first_nz = next_sig_pos
                rem = abs(val) - 1
                coeff_signs = (coeff_signs * 2 if next_sig_pos != scan_pos_last
                               else coeff_signs) + (1 if val < 0 else 0)
                gt1 = 1 if rem else 0
                cabac.encode_bin(gt1_base + off, gt1)
                reg_bins -= 1
                if gt1:
                    rem -= 1
                    cabac.encode_bin(par_base + off, rem & 1)
                    rem >>= 1
                    reg_bins -= 1
                    gt2 = 1 if rem else 0
                    cabac.encode_bin(gt2_base + off, gt2)
                    reg_bins -= 1

            quant_state = (dq_table >> ((quant_state << 2)
                                        + ((val & 1) << 1))) & 3
            next_sig_pos -= 1

        # second pass: go-rice remainders for abs >= 4
        for sp in range(first_sig_pos, next_sig_pos, -1):
            blk_pos = int(scan[sp])
            a = abs(int(flat[blk_pos]))
            if a >= 4:
                pos_y, pos_x = divmod(blk_pos, w)
                cabac.write_coeff_remain((a - 4) >> 1,
                                         int(rice4_map[pos_y, pos_x]), 5)

        # third pass: full bypass positions
        for sp in range(next_sig_pos, min_sub_pos - 1, -1):
            blk_pos = int(scan[sp])
            pos_y, pos_x = divmod(blk_pos, w)
            a = abs(int(flat[blk_pos]))
            rice = int(rice0_map[pos_y, pos_x])
            pos0 = (1 if quant_state < 2 else 2) << rice
            remainder = pos0 if a == 0 else (a - 1 if a <= pos0 else a)
            cabac.write_coeff_remain(remainder, rice, 5)
            quant_state = (dq_table >> ((quant_state << 2)
                                        + ((a & 1) << 1))) & 3
            if a:
                num_non_zero += 1
                first_nz = sp
                last_nz = max(last_nz, sp)
                coeff_signs = (coeff_signs << 1) + (1 if int(flat[blk_pos]) < 0 else 0)

        num_signs = num_non_zero
        if signhide and not dep_quant and last_nz - first_nz >= 4:
            num_signs -= 1
            coeff_signs >>= 1
        if is_luma:
            mts_last_scan_pos |= first_sig_pos > 0
        cabac.encode_bins_ep(coeff_signs, num_signs)

    max_lfnst_pos = 7 if (w, h) in ((4, 4), (8, 8)) else 15
    return {
        "last_scan_pos": scan_pos_last,
        "violates_lfnst": (w >= 4 and h >= 4) and scan_pos_last > max_lfnst_pos,
        "lfnst_last_scan_pos": scan_pos_last >= 1,
        "mts_last_scan_pos": mts_last_scan_pos,
    }


def decode_coeff_nxn(dec: CabacDecoder, w: int, h: int, is_luma: bool,
                     dep_quant: bool = False, signhide: bool = False) -> np.ndarray:
    """Decode one TU's coefficients; mirror of encode_coeff_nxn."""
    lw, lh = _log2(w), _log2(h)
    sw, sh = log2_sbb_size(lw, lh)
    log2_cg_size = sw + sh
    scan = coeff_scan_table(lw, lh)
    scan_cg = cg_scan_table(lw, lh)
    flat = np.zeros(w * h, dtype=np.int64)

    last_x, last_y = decode_last_sig_xy(dec, w, h, not is_luma)
    pos_last = last_y * w + last_x
    scan_pos_last = int(np.nonzero(scan == pos_last)[0][0])
    scan_cg_last = scan_pos_last >> log2_cg_size

    cg_grid_w = w >> sw
    cg_grid_h = h >> sh
    sig_cg = np.zeros(cg_grid_w * cg_grid_h, dtype=np.int32)
    base_cg_ctx = OFF["sig_coeff_group"] + (0 if is_luma else 2)
    sig_base = [OFF["sig_luma_0"], OFF["sig_luma_1"], OFF["sig_luma_2"]] if is_luma \
        else [OFF["sig_chroma_0"], OFF["sig_chroma_1"], OFF["sig_chroma_2"]]
    gt1_base = OFF["gt1_luma"] if is_luma else OFF["gt1_chroma"]
    gt2_base = OFF["gt2_luma"] if is_luma else OFF["gt2_chroma"]
    par_base = OFF["parity_luma"] if is_luma else OFF["parity_chroma"]

    dq_table = DQ_TRANSITION if dep_quant else 0
    quant_state = 0
    temp_diag = -1
    temp_sum = -1
    reg_bins = (w * h * 28) >> 4

    for i in range(scan_cg_last, -1, -1):
        cg_blk_pos = int(scan_cg[i])
        cg_pos_y, cg_pos_x = divmod(cg_blk_pos, cg_grid_w)

        if i == scan_cg_last or i == 0:
            sig_cg[cg_blk_pos] = 1
        else:
            right = sig_cg[cg_blk_pos + 1] if cg_pos_x + 1 < cg_grid_w else 0
            lower = sig_cg[cg_blk_pos + cg_grid_w] if cg_pos_y + 1 < cg_grid_h else 0
            ctx = 1 if (right or lower) else 0
            sig_cg[cg_blk_pos] = dec.decode_bin(base_cg_ctx + ctx)

        if not sig_cg[cg_blk_pos]:
            continue

        min_sub_pos = i << log2_cg_size
        first_sig_pos = scan_pos_last if i == scan_cg_last \
            else min_sub_pos + (1 << log2_cg_size) - 1
        next_sig_pos = first_sig_pos
        infer_sig_pos = next_sig_pos if next_sig_pos == scan_pos_last \
            else (min_sub_pos if i != 0 else -1)
        num_non_zero = 0
        gt2_pos = []
        nz_pos = []

        while next_sig_pos >= min_sub_pos and reg_bins >= 4:
            blk_pos = int(scan[next_sig_pos])
            pos_y, pos_x = divmod(blk_pos, w)
            if num_non_zero or next_sig_pos != infer_sig_pos:
                ctx_sig, temp_diag, temp_sum = _sig_ctx_idx_abs(
                    flat, pos_x, pos_y, w, h, is_luma)
                base = sig_base[max(0, quant_state - 1)]
                sig = dec.decode_bin(base + (ctx_sig if is_luma else min(ctx_sig, 7)))
                reg_bins -= 1
            else:
                sig = 1
                if next_sig_pos != scan_pos_last:
                    ctx_sig, temp_diag, temp_sum = _sig_ctx_idx_abs(
                        flat, pos_x, pos_y, w, h, is_luma)

            if sig:
                off = _gtx_ctx_offset(temp_diag, temp_sum, is_luma)
                num_non_zero += 1
                nz_pos.append(next_sig_pos)
                gt1 = dec.decode_bin(gt1_base + off)
                reg_bins -= 1
                par = 0
                gt2 = 0
                if gt1:
                    par = dec.decode_bin(par_base + off)
                    reg_bins -= 1
                    gt2 = dec.decode_bin(gt2_base + off)
                    reg_bins -= 1
                    if gt2:
                        gt2_pos.append(next_sig_pos)
                flat[blk_pos] = 1 + gt1 + par + 2 * gt2

            quant_state = (dq_table >> ((quant_state << 2)
                                        + ((int(flat[blk_pos]) & 1) << 1))) & 3
            next_sig_pos -= 1

        gt2_set = set(gt2_pos)
        for sp in range(first_sig_pos, next_sig_pos, -1):
            blk_pos = int(scan[sp])
            pos_y, pos_x = divmod(blk_pos, w)
            rice = int(GO_RICE_PARS[_abs_sum(flat, pos_x, pos_y, w, h, 4)])
            if sp in gt2_set:
                flat[blk_pos] += 2 * dec.decode_coeff_remain(rice, 5)

        for sp in range(next_sig_pos, min_sub_pos - 1, -1):
            blk_pos = int(scan[sp])
            pos_y, pos_x = divmod(blk_pos, w)
            rice = int(GO_RICE_PARS[_abs_sum(flat, pos_x, pos_y, w, h, 0)])
            pos0 = (1 if quant_state < 2 else 2) << rice
            remainder = dec.decode_coeff_remain(rice, 5)
            a = 0 if remainder == pos0 else (remainder + 1 if remainder < pos0 else remainder)
            flat[blk_pos] = a
            quant_state = (dq_table >> ((quant_state << 2)
                                        + ((a & 1) << 1))) & 3
            if a:
                num_non_zero += 1
                nz_pos.append(sp)

        # signs: one bit per nonzero in descending scan order
        nz_pos.sort(reverse=True)
        num_signs = num_non_zero
        hidden = signhide and not dep_quant and nz_pos and \
            (nz_pos[0] - nz_pos[-1] >= 4)
        if hidden:
            num_signs -= 1
        sign_bits = dec.decode_bins_ep(num_signs) if num_signs else 0
        abs_sum_cg = 0
        for k, sp in enumerate(nz_pos[:num_signs]):
            blk_pos = int(scan[sp])
            if (sign_bits >> (num_signs - 1 - k)) & 1:
                flat[blk_pos] = -flat[blk_pos]
        if hidden:
            for sp in nz_pos:
                abs_sum_cg += abs(int(flat[int(scan[sp])]))
            sp = nz_pos[-1]
            blk_pos = int(scan[sp])
            if abs_sum_cg & 1:
                flat[blk_pos] = -flat[blk_pos]

    return flat.reshape(h, w).astype(np.int32)
