"""Decode a full Annex-B VVC stream using PARSED headers — including
streams produced by OTHER encoders (the uvg266 reference binary).

Unlike `decoder.decode_au` (which verifies the repo encoder's output
against regenerated headers and encoder-side state), this decoder derives
everything from the bits: SPS/PPS via `hls.header_parse`, per-slice QP /
SAO / ALF enables / ref lists from the parsed slice header, ALF and
scaling-list coefficients from APS NALs, and the DPB from decoded
pictures.  Decoding a reference-binary stream to matching
decoded-picture-hash SEI values is the strongest independence evidence
available without a VTM binary.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream.bitwriter import BitstreamReader, strip_emulation_prevention
from ..bitstream.cabac import CabacDecoder
from ..consts import LCU_WIDTH, NalType, SliceType
from ..hls import headers
from ..hls.header_parse import (ParsedPps, ParsedSps, UnsupportedStream,
                                config_from_headers, parse_pps,
                                parse_slice_header, parse_sps)
from .decoder import Nal, _escaped_len, split_nals


@dataclass
class DecodedFrame:
    poc: int = 0
    slicetype: int = SliceType.I
    qp: int = 0
    rec: object = None                  # FramePlanes (with .motion if tmvp)
    checksum_ok: bool | None = None     # None = no hash SEI present
    cus: list = None                    # decoded CuInfo leaves (analysis)


def _full_poc(poc_lsb: int, lsb_bits: int, prev_poc: int) -> int:
    """Standard POC msb derivation (VVC 8.3.1) against the previous POC."""
    max_lsb = 1 << lsb_bits
    prev_lsb = prev_poc & (max_lsb - 1)
    prev_msb = prev_poc - prev_lsb
    if poc_lsb < prev_lsb and prev_lsb - poc_lsb >= max_lsb // 2:
        return prev_msb + max_lsb + poc_lsb
    if poc_lsb > prev_lsb and poc_lsb - prev_lsb > max_lsb // 2:
        return prev_msb - max_lsb + poc_lsb
    return prev_msb + poc_lsb


def decode_stream(data: bytes, copy_rpl1: bool | None = None
                  ) -> list[DecodedFrame]:
    """Decode every access unit of an Annex-B stream.

    Returns one DecodedFrame per VCL NAL in decode order. Raises
    UnsupportedStream / ValueError on syntax outside the supported
    envelope; a checksum mismatch sets checksum_ok=False (callers assert).
    """
    from ..control.encoder import (FramePlanes, RefLists,
                                   reconstruct_inter_cu,
                                   reconstruct_intra_cu)
    from ..control.params import EncoderControl, FrameState
    from ..hls.coding_tree import CodingTreeReader

    nals = split_nals(data)
    sps: ParsedSps | None = None
    pps: ParsedPps | None = None
    cfg = None
    ctrl = None
    alf_aps = {}                        # aps_id -> parsed AlfFrameParams
    lmcs_aps = {}                       # aps_id -> ParsedLmcsAps
    dpb: dict[int, object] = {}         # poc -> FramePlanes
    out: list[DecodedFrame] = []
    prev_poc = 0

    i = 0
    while i < len(nals):
        nal = nals[i]
        if nal.type == NalType.SPS_NUT:
            rd = BitstreamReader(strip_emulation_prevention(nal.payload))
            sps = parse_sps(rd)
        elif nal.type == NalType.PPS_NUT:
            rd = BitstreamReader(strip_emulation_prevention(nal.payload))
            pps = parse_pps(rd)
            cfg = config_from_headers(sps, pps)
            # the bitstream is authoritative: never shed tool combos
            ctrl = EncoderControl(cfg, apply_tool_guards=False)
            if pps.tiles:
                # geometry check: explicit tile sizes must match the
                # uniform grid EncoderControl derives from the counts
                col_w = [b - a for a, b in
                         zip(ctrl.tile_col_bd, ctrl.tile_col_bd[1:])]
                row_h = [b - a for a, b in
                         zip(ctrl.tile_row_bd, ctrl.tile_row_bd[1:])]
                if tuple(col_w) != pps.tile_cols \
                        or tuple(row_h) != pps.tile_rows:
                    raise UnsupportedStream(
                        f"non-uniform tile grid {pps.tile_cols}x"
                        f"{pps.tile_rows}")
        elif nal.type == NalType.PREFIX_APS_NUT:
            rd = BitstreamReader(strip_emulation_prevention(nal.payload))
            aps_type = rd.read(3)
            aps_id = rd.read(5)
            if aps_type == 0:           # ALF
                from ..hls.alf_syntax import parse_alf_aps
                rd2 = BitstreamReader(strip_emulation_prevention(nal.payload))
                alf_aps[aps_id] = parse_alf_aps(
                    rd2, sps.chroma_format != 0)
            elif aps_type == 1:         # LMCS
                from ..hls.header_parse import parse_lmcs_aps
                rd2 = BitstreamReader(strip_emulation_prevention(nal.payload))
                lmcs_aps[aps_id] = parse_lmcs_aps(rd2)
            elif aps_type == 2:         # scaling list
                from ..hls.scaling_list_syntax import parse_scaling_aps
                rd2 = BitstreamReader(strip_emulation_prevention(nal.payload))
                ctrl.scaling_lists = parse_scaling_aps(rd2)
        elif nal.type <= NalType.GDR_NUT:       # VCL
            if cfg is None:
                raise UnsupportedStream("slice before parameter sets")
            frame, prev_poc, n_extra = _decode_slice(
                nal, nals[i + 1:], sps, pps, cfg, ctrl, alf_aps, lmcs_aps,
                dpb, prev_poc, copy_rpl1)
            out.append(frame)
            i += n_extra
        i += 1
    return out


def _decode_slice(nal: Nal, following: list[Nal], sps: ParsedSps,
                  pps: ParsedPps, cfg, ctrl, alf_aps: dict, lmcs_aps: dict,
                  dpb: dict, prev_poc: int, copy_rpl1: bool | None):
    from ..bitstream.ctx_tables import OFF as CTX_OFF
    from ..control.encoder import (FramePlanes, RefLists,
                                   reconstruct_inter_cu,
                                   reconstruct_intra_cu)
    from ..control.inter_cand import TmvpCtx, build_motion_field
    from ..control.params import FrameState
    from ..control.sao import decode_sao_ctu, sao_apply_frame
    from ..hls.coding_tree import CodingTreeReader

    rbsp = strip_emulation_prevention(nal.payload)
    tiles_mode = ctrl.tiles_enable
    n_tiles = cfg.tiles_width_count * cfg.tiles_height_count
    wpp_mode = cfg.wpp and ctrl.height_in_lcu > 1 and not tiles_mode
    num_subs = n_tiles if tiles_mode else (
        ctrl.height_in_lcu if wpp_mode else 1)

    def _try_parse(copy, nsubs):
        rd = BitstreamReader(rbsp)
        return parse_slice_header(rd, sps, pps, nal.type,
                                  num_substreams=nsubs, copy_rpl1=copy)

    # candidate (copy_rpl1, num_substreams) conventions, in preference
    # order. A 1-substream parse of a tiled stream means uvg
    # --slices tiles (one VCL NAL per tile, no entry points).
    if copy_rpl1 is None and nal.type not in (NalType.IDR_W_RADL,
                                              NalType.IDR_N_LP):
        copies = [False, True]
    else:
        copies = [bool(copy_rpl1)]
    # per-tile slice mode is detected structurally: the picture's VCL
    # NALs arrive back-to-back (n_tiles of them), while entry-point mode
    # has exactly one VCL per AU. A wrong num_substreams guess would
    # still "parse" (the entry-point fields would read CABAC payload
    # bytes), so the NAL layout is the only reliable signal.
    n_follow = 0
    for n2 in following:
        if n2.type > NalType.GDR_NUT:
            break
        n_follow += 1
    # tiles-mode per-tile slices drop the entry points entirely, so the
    # first header only parses with one substream; WPP row-slices keep
    # the full entry-point header on the first NAL (detected later by
    # payload length), so they parse with num_subs.
    if tiles_mode and n_tiles > 1 and n_follow >= num_subs - 1:
        cands = [(c, 1) for c in copies]
    else:
        cands = [(c, num_subs) for c in copies]
    sh = None
    err = None
    for (copy_used, nsubs_used) in cands:
        try:
            sh = _try_parse(copy_used, nsubs_used)
            break
        except (UnsupportedStream, ValueError) as e:
            err = e
    if sh is None:
        raise err

    poc = _full_poc(sh.poc_lsb, sps.poc_lsb_bits, prev_poc) \
        if not sh.is_idr else sh.poc_lsb
    fs = FrameState(num=0, poc=poc,
                    pictype=nal.type,
                    slicetype=sh.slicetype, qp=sh.qp,
                    jccr_sign=sh.jccr_sign,
                    ref_pocs_neg=sh.ref_neg, ref_pocs_pos=sh.ref_pos)

    # reference lists from the DPB
    pocs0 = [poc - d for d in sh.ref_neg]
    pocs1 = [poc + d for d in sh.ref_pos] if sh.ref_pos \
        else list(pocs0)                # lowdelay: L1 = L0
    if sh.slicetype == SliceType.I:
        rl = RefLists(l0=[], l1=[], pocs0=[], pocs1=[])
    else:
        try:
            l0 = [dpb[p] for p in pocs0]
            l1 = [dpb[p] for p in pocs1]
        except KeyError as e:
            raise UnsupportedStream(f"reference POC {e} not in DPB")
        rl = RefLists(l0=l0, l1=l1, pocs0=pocs0, pocs1=pocs1)

    # locate CABAC payload / substreams in the escaped domain
    hdr_rbsp_len = sh.payload_bit_pos // 8
    hdr_esc_len = _escaped_len(nal.payload, hdr_rbsp_len)
    payload_esc = nal.payload[hdr_esc_len:]
    n_extra = 0
    if ((tiles_mode and n_tiles > 1) or wpp_mode) and num_subs > 1 \
            and not sh.entry_lengths:
        # uvg --slices tiles/wpp: one VCL NAL per tile (or per CTU
        # row), each with a full PH-in-SH header and no entry points
        # (the reference emits the same PPS as single-slice mode;
        # substreams map to slices in decode order,
        # encoder_state-bitstream.c:1248 'independent' slices). WPP
        # context inheritance still applies across the row-slices.
        subs = [strip_emulation_prevention(payload_esc)]
        for n2 in following:
            if n2.type > NalType.GDR_NUT:
                break
            rd2 = BitstreamReader(strip_emulation_prevention(n2.payload))
            sh2 = parse_slice_header(rd2, sps, pps, n2.type,
                                     num_substreams=1,
                                     copy_rpl1=copy_used)
            if sh2.poc_lsb != sh.poc_lsb:
                break
            h2_rbsp = sh2.payload_bit_pos // 8
            h2_esc = _escaped_len(n2.payload, h2_rbsp)
            subs.append(strip_emulation_prevention(
                n2.payload[h2_esc:]))
            n_extra += 1
            if 1 + n_extra == num_subs:
                break
        if 1 + n_extra != num_subs:
            raise UnsupportedStream(
                f"per-substream slices: got {1 + n_extra} of {num_subs}")
        following = following[n_extra:]
    elif sh.entry_lengths:
        if wpp_mode and n_follow >= num_subs - 1 \
                and len(payload_esc) <= sum(sh.entry_lengths):
            # uvg --slices wpp: the first NAL's header still lists
            # entry-point offsets for every row, but its payload holds
            # only row 0 — the remaining rows follow as their own
            # 'dependent' slice NALs (encoderstate children writer,
            # encoder_state-bitstream.c:1493-1506). WPP context
            # inheritance applies across the row-slices unchanged.
            subs = [strip_emulation_prevention(payload_esc)]
            for n2 in following:
                if n2.type > NalType.GDR_NUT:
                    break
                rd2 = BitstreamReader(
                    strip_emulation_prevention(n2.payload))
                sh2 = parse_slice_header(rd2, sps, pps, n2.type,
                                         num_substreams=1,
                                         copy_rpl1=copy_used)
                if sh2.poc_lsb != sh.poc_lsb:
                    break
                h2_rbsp = sh2.payload_bit_pos // 8
                h2_esc = _escaped_len(n2.payload, h2_rbsp)
                subs.append(strip_emulation_prevention(
                    n2.payload[h2_esc:]))
                n_extra += 1
                if 1 + n_extra == num_subs:
                    break
            if 1 + n_extra != num_subs:
                raise UnsupportedStream(
                    f"per-row slices: got {1 + n_extra} of {num_subs}")
            following = following[n_extra:]
        else:
            bounds, pos = [], 0
            for ln in sh.entry_lengths:
                bounds.append((pos, pos + ln))
                pos += ln
            bounds.append((pos, len(payload_esc)))
            subs = [strip_emulation_prevention(payload_esc[a:b])
                    for (a, b) in bounds]
    else:
        subs = [strip_emulation_prevention(payload_esc)]

    dec = CabacDecoder(BitstreamReader(subs[0]))
    dec.init_contexts(fs.qp, fs.slicetype)
    tmvp = None
    if cfg.tmvp_enable and sh.tmvp_in_ph and sh.slicetype != SliceType.I:
        tmvp = TmvpCtx.from_reflists(rl, poc)
    is_intra_slice = sh.slicetype == SliceType.I
    reader = CodingTreeReader(dec, cfg, ctrl, is_irap=sh.is_irap,
                              is_intra_slice=is_intra_slice,
                              num_ref=(len(rl.l0), len(rl.l1)),
                              ref_pocs=[rl.pocs0, rl.pocs1],
                              is_b_slice=sh.slicetype == SliceType.B,
                              tmvp=tmvp)
    qp_delta_on = bool(getattr(pps, "cu_qp_delta", False))
    if qp_delta_on:
        reader.enable_qp_delta(fs.qp)
    if tiles_mode:
        reader.cu_map.set_tile_map(ctrl)

    w, h = ctrl.in_width, ctrl.in_height
    has_chroma = ctrl.chroma_format != 0
    rec = FramePlanes(
        np.zeros((h, w), dtype=np.int32),
        np.zeros((h >> 1, w >> 1), dtype=np.int32) if has_chroma else None,
        np.zeros((h >> 1, w >> 1), dtype=np.int32) if has_chroma else None)
    coded_mask = np.zeros((-(-h // 4), -(-w // 4)), dtype=bool)
    chroma_mask_c = np.zeros_like(coded_mask)   # dual-tree chroma pass
    chroma_cus: list = []                       # dual-tree chroma-tree CUs

    sao_on = sh.sao_luma or sh.sao_chroma
    if sao_on and not sh.sao_luma:
        raise UnsupportedStream("SAO chroma-only slice")
    sao_luma: list = [None] * (ctrl.width_in_lcu * ctrl.height_in_lcu) \
        if tiles_mode else []
    sao_chroma: list = [None] * (ctrl.width_in_lcu * ctrl.height_in_lcu) \
        if tiles_mode else []

    # ALF slice config: coefficients from the APS pool, enables from the
    # parsed slice header
    alf_p = None
    if sh.alf_luma or sh.alf_cb or sh.alf_cr:
        from ..control.alf import AlfFrameParams

        def pool(aps_id):
            if aps_id not in alf_aps:
                raise UnsupportedStream(f"ALF APS {aps_id} not seen")
            return alf_aps[aps_id]

        alf_p = AlfFrameParams()
        alf_p.luma_enabled = sh.alf_luma
        alf_p.cb_enabled = sh.alf_cb
        alf_p.cr_enabled = sh.alf_cr
        alf_p.cc_cb_enabled = sh.alf_cc_cb
        alf_p.cc_cr_enabled = sh.alf_cc_cr
        if sh.alf_luma:
            # slice APS pool for alf_ctb_filter_index (temporal APS
            # reuse; an empty list = fixed filter sets only)
            alf_p.luma_aps_list = [pool(i) for i in sh.alf_aps_luma]
            alf_p.num_luma_aps = len(alf_p.luma_aps_list)
            if alf_p.num_luma_aps:
                first = alf_p.luma_aps_list[0]
                alf_p.luma_coeffs = first.luma_coeffs
                alf_p.filter_map = first.filter_map
                alf_p.num_filters = first.num_filters
                alf_p.luma_clip = first.luma_clip
        if sh.alf_cb or sh.alf_cr:
            c_aps = pool(sh.alf_aps_chroma)
            alf_p.chroma_coeffs = c_aps.chroma_coeffs
            alf_p.chroma_alts = c_aps.chroma_alts
            alf_p.chroma_clip = c_aps.chroma_clip
            alf_p.num_chroma_alts = c_aps.num_chroma_alts
        if sh.alf_cc_cb:
            alf_p.cc_cb_coeffs = pool(sh.alf_aps_cc_cb).cc_cb_coeffs
        if sh.alf_cc_cr:
            alf_p.cc_cr_coeffs = pool(sh.alf_aps_cc_cr).cc_cr_coeffs
        wl_hl = ctrl.width_in_lcu * ctrl.height_in_lcu
        alf_p.ctu_flags_y = np.zeros(wl_hl, dtype=bool)
        alf_p.ctu_flags_cb = np.zeros(wl_hl, dtype=bool)
        alf_p.ctu_flags_cr = np.zeros(wl_hl, dtype=bool)
        alf_p.cc_flags_cb = np.zeros(wl_hl, dtype=bool)
        alf_p.cc_flags_cr = np.zeros(wl_hl, dtype=bool)
        alf_p.ctu_alt_cb = np.zeros(wl_hl, dtype=np.int32)
        alf_p.ctu_alt_cr = np.zeros(wl_hl, dtype=np.int32)
        alf_p.ctu_filter_set = np.full(wl_hl, 16, dtype=np.int32)

    # LMCS: per-picture reshaper from the parsed APS + PH flags
    lmcs_ctx = None
    if sh.lmcs_enabled:
        if sh.lmcs_aps_id not in lmcs_aps:
            raise UnsupportedStream(f"LMCS APS {sh.lmcs_aps_id} not seen")
        from ..ops.lmcs import LmcsFrameCtx, build_luts
        laps = lmcs_aps[sh.lmcs_aps_id]
        luts = build_luts(laps.bin_cw(ctrl.bitdepth), ctrl.bitdepth,
                          crs_offset=laps.crs_offset)
        lmcs_ctx = LmcsFrameCtx(luts, rec.y, sps.width, sps.height,
                                chroma_adj=sh.lmcs_chroma_scale)

    all_cus = []

    def decode_one_ctu(cx, cy, x_rel=None, y_rel=None, tile_rect=None):
        if sao_on:
            decode_sao_ctu(dec, CTX_OFF, cx, cy, ctrl.width_in_lcu,
                           sao_luma, sao_chroma,
                           has_chroma and sh.sao_chroma, ctrl.bitdepth,
                           x_rel=x_rel, y_rel=y_rel)
        if alf_p is not None:
            from ..hls.alf_syntax import decode_alf_ctu
            decode_alf_ctu(dec, CTX_OFF, cy * ctrl.width_in_lcu + cx,
                           ctrl.width_in_lcu, alf_p, has_chroma)
        dual = bool(cfg.dual_tree) and is_intra_slice \
            and not tiles_mode and not wpp_mode
        if dual:
            node = reader.decode_ctu(cx * LCU_WIDTH, cy * LCU_WIDTH,
                                     tree_type=1)
            for leaf in node.leaves():
                reconstruct_intra_cu(leaf.cu, rec, coded_mask, ctrl,
                                     fs.qp, parts="luma", lmcs=lmcs_ctx)
                all_cus.append(leaf.cu)
            node_c = reader.decode_ctu(cx * LCU_WIDTH, cy * LCU_WIDTH,
                                       tree_type=2)
            for leaf in node_c.leaves():
                reconstruct_intra_cu(leaf.cu, rec, coded_mask, ctrl,
                                     fs.qp, parts="chroma",
                                     jccr_sign=fs.jccr_sign, lmcs=lmcs_ctx,
                                     chroma_mask=chroma_mask_c)
                chroma_cus.append(leaf.cu)
            return
        node = reader.decode_ctu(cx * LCU_WIDTH, cy * LCU_WIDTH)
        for leaf in node.leaves():
            cu_qp = leaf.cu.qp if qp_delta_on else fs.qp
            if leaf.cu.type == 1:
                reconstruct_intra_cu(leaf.cu, rec, coded_mask, ctrl, cu_qp,
                                     tile_rect=tile_rect,
                                     jccr_sign=fs.jccr_sign, lmcs=lmcs_ctx)
            elif leaf.cu.type == 3:
                from ..control.encoder import reconstruct_ibc_cu
                reconstruct_ibc_cu(leaf.cu, rec, coded_mask, ctrl, cu_qp)
            else:
                reconstruct_inter_cu(leaf.cu, rec, coded_mask, ctrl,
                                     cu_qp, rl, lmcs=lmcs_ctx)
            all_cus.append(leaf.cu)

    if tiles_mode:
        for t in range(n_tiles):
            if t > 0:
                dec = CabacDecoder(BitstreamReader(subs[t]))
                dec.init_contexts(fs.qp, fs.slicetype)
                reader.dec = dec
                reader.sc.c = dec
            reader.cu_map.cur_tile = t
            if hasattr(reader, "hmvp"):
                reader.hmvp.cur_tile = t
            if reader.qp_state is not None:
                # per-tile encoder state: last_qp re-inits to the slice
                # QP at each tile start (encoderstate.c:1015)
                reader.qp_state["last_qp"] = fs.qp
                reader.qp_state["last_cu_qp"] = fs.qp
            tile_rect = ctrl.tile_bounds_px(t)
            col0 = tile_rect[0] // LCU_WIDTH
            row0 = tile_rect[1] // LCU_WIDTH
            for (cx, cy) in ctrl.tile_ctus(t):
                decode_one_ctu(cx, cy, x_rel=cx - col0, y_rel=cy - row0,
                               tile_rect=tile_rect)
            if not dec.decode_bin_trm():
                raise ValueError(f"expected end_of_tile bin, tile {t}")
    else:
        snapshot = None
        for cty in range(ctrl.height_in_lcu):
            if wpp_mode and cty > 0:
                dec = CabacDecoder(BitstreamReader(subs[cty]))
                dec.init_contexts(fs.qp, fs.slicetype)
                if snapshot is not None:
                    dec.load_ctx(snapshot)
                reader.dec = dec
                reader.sc.c = dec
            for ctx_ in range(ctrl.width_in_lcu):
                decode_one_ctu(ctx_, cty)
                if wpp_mode and ctx_ == 0:
                    snapshot = dec.save_ctx()
            if wpp_mode:
                if not dec.decode_bin_trm():
                    raise ValueError(f"expected end_of_subset bin, row {cty}")
        if not wpp_mode and not dec.decode_bin_trm():
            raise ValueError("expected end_of_slice terminate bin")

    # with pps_loop_filter_across_tiles_enabled_flag==0, deblock/SAO treat
    # interior tile boundaries like the picture border
    tb = None
    if tiles_mode and not pps.loop_filter_across_tiles:
        tb = ([b * LCU_WIDTH for b in ctrl.tile_col_bd[1:-1]],
              [b * LCU_WIDTH for b in ctrl.tile_row_bd[1:-1]])
    # LMCS: inverse-map the recon luma before the loop filters
    if lmcs_ctx is not None:
        rec.y[:] = lmcs_ctx.luts.inv_lut[rec.y]
    if cfg.deblock_enable:
        from ..native import deblock_frame_native
        qp4_map = cqp_lut = None
        if qp_delta_on:
            h4, w4 = -(-h // 4), -(-w // 4)
            qp4_map = np.zeros((h4, w4), dtype=np.int32)
            for cu in all_cus:
                qp4_map[cu.y // 4:(cu.y + cu.h) // 4,
                        cu.x // 4:(cu.x + cu.w) // 4] = cu.qp
            cqp_lut = [ctrl.get_chroma_qp(q) for q in range(64)]
        deblock_frame_native(rec, all_cus, fs.qp, ctrl.get_chroma_qp(fs.qp),
                             cfg.deblock_beta, cfg.deblock_tc, ctrl.bitdepth,
                             ref_pocs=[rl.pocs0, rl.pocs1],
                             tile_boundaries=tb,
                             cus_chroma=chroma_cus or None,
                             qp_map=qp4_map, cqp_lut=cqp_lut)
    if sao_on:
        sao_apply_frame(rec, sao_luma, sao_chroma, ctrl, ctrl.bitdepth,
                        tile_boundaries=tb)
    if alf_p is not None:
        from ..control.alf import alf_apply_frame, cc_alf_apply
        pre_alf_luma = rec.y.copy() \
            if (alf_p.cc_cb_enabled or alf_p.cc_cr_enabled) else None
        alf_apply_frame(rec, alf_p, ctrl, ctrl.bitdepth)
        if pre_alf_luma is not None:
            cc_alf_apply(rec, pre_alf_luma, alf_p, ctrl, ctrl.bitdepth)

    if cfg.tmvp_enable:
        rec.motion = build_motion_field(reader.cu_map, rl.pocs0, rl.pocs1)
    dpb[poc] = rec

    frame = DecodedFrame(poc=poc, slicetype=sh.slicetype, qp=sh.qp, rec=rec,
                         cus=all_cus + chroma_cus)
    # hash SEI: first suffix SEI after this VCL NAL (before the next one)
    for n in following:
        if n.type <= NalType.GDR_NUT:
            break
        if n.type == NalType.SUFFIX_SEI_NUT:
            pl = strip_emulation_prevention(n.payload)
            if pl[0] == 132:
                planes = [p for p in (rec.y, rec.u, rec.v) if p is not None]
                hash_type = pl[2]
                per = 16 if hash_type == 0 else 4
                ok, off = True, 4
                for p in planes:
                    exp = headers.image_md5(p, ctrl.bitdepth) \
                        if hash_type == 0 \
                        else headers.image_checksum(p, ctrl.bitdepth)
                    ok &= bytes(pl[off:off + per]) == exp
                    off += per
                frame.checksum_ok = ok
            break
    return frame, poc, n_extra
