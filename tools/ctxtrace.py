"""Compare our decoder's CABAC context evolution against the reference
binary's --cabac-debug-file trace.

The reference dumps, after encoding EVERY leaf CU, the record
    "E %4d %4d %9d %d"  (x, y, split_tree, tree_type)
followed by the raw 2094-byte ctx struct: 349 contexts x 6 bytes
(u16 state[2] + u8 rate + pad), struct order cabac.h:68-130.
We decode the same stream with CodingTreeReader, snapshot (s0, s1) after
every leaf, and diff per context family — pinpointing the first divergent
syntax element.

This is a host-only CABAC-bin debugging tool: it decodes on the CPU and
never opens an accelerator, so it pins JAX to the CPU backend.

Usage: python tools/ctxtrace.py stream.266 trace.bin
"""
from __future__ import annotations

import struct
import sys

# (uvg family name, count, our OFF name or None if we lack the family)
UVG_CTX_LAYOUT = [
    ("alf_ctb_flag", 9, "alf_ctb_flag"),
    ("alf_latest_filt", 1, None),
    ("alf_temporal_filt", 1, "alf_temporal_filt"),
    ("alf_ctb_alternatives", 2, "alf_ctb_alternatives"),
    ("alf_luma_coeff_delta_prediction_flag", 1, None),
    ("alf_cc_filter_control_flag", 6, "alf_cc_filter_control_flag"),
    ("sao_merge_flag", 1, "sao_merge_flag"),
    ("sao_type_idx", 1, "sao_type_idx"),
    ("lfnst_idx", 3, "lfnst_idx"),
    ("mts_idx", 4, "mts_idx"),
    ("split_flag", 9, "split_flag"),
    ("qt_split_flag", 6, "qt_split_flag"),
    ("mtt_vertical", 5, "mtt_vertical"),
    ("mtt_binary", 4, "mtt_binary"),
    ("non_inter_flag", 2, "non_inter_flag"),
    ("intra_luma_mpm_flag", 1, "intra_luma_mpm_flag"),
    ("intra_subpart", 2, "intra_subpart"),
    ("chroma_pred", 1, "chroma_pred"),
    ("inter_dir", 6, "inter_dir"),
    ("imv_flag", 5, "imv_flag"),
    ("qt_cbf_luma", 4, "qt_cbf_luma"),
    ("qt_cbf_cr", 3, "qt_cbf_cr"),
    ("qt_cbf_cb", 2, "qt_cbf_cb"),
    ("cu_qp_delta_abs", 2, "cu_qp_delta_abs"),
    ("part_size", 4, "part_size"),
    ("sig_luma_0", 12, "sig_luma_0"),
    ("sig_luma_1", 12, "sig_luma_1"),
    ("sig_luma_2", 12, "sig_luma_2"),
    ("sig_chroma_0", 8, "sig_chroma_0"),
    ("sig_chroma_1", 8, "sig_chroma_1"),
    ("sig_chroma_2", 8, "sig_chroma_2"),
    ("parity_luma", 21, "parity_luma"),
    ("parity_chroma", 11, "parity_chroma"),
    # uvg bank 0 holds the gt2 (abs>2) contexts (context.c:631)
    ("gtx_luma_0", 21, "gt2_luma"),
    ("gtx_luma_1", 21, "gt1_luma"),
    ("gtx_chroma_0", 11, "gt2_chroma"),
    ("gtx_chroma_1", 11, "gt1_chroma"),
    ("last_y_luma", 20, "last_y_luma"),
    ("last_y_chroma", 3, "last_y_chroma"),
    ("last_x_luma", 20, "last_x_luma"),
    ("last_x_chroma", 3, "last_x_chroma"),
    ("cu_pred_mode", 2, "cu_pred_mode"),
    ("cu_skip_flag", 3, "cu_skip_flag"),
    ("cu_merge_idx_ext", 1, "cu_merge_idx_ext"),
    ("cu_merge_flag_ext", 1, "cu_merge_flag_ext"),
    ("cu_transquant_bypass", 1, "cu_transquant_bypass"),
    ("cu_mvd", 2, "cu_mvd"),
    ("cu_ref_pic", 2, "cu_ref_pic"),
    ("mvp_idx", 1, "mvp_idx"),
    ("cu_qt_root_cbf", 1, "cu_qt_root_cbf"),
    ("sig_coeff_group", 4, "sig_coeff_group"),
    ("luma_planar", 2, "luma_planar"),
    ("multi_ref_line", 2, "multi_ref_line"),
    ("mip_flag", 4, "mip_flag"),
    ("bdpcm_mode", 4, "bdpcm_mode"),
    ("joint_cb_cr", 3, "joint_cb_cr"),
    ("transform_skip_luma", 1, "transform_skip_luma"),
    ("transform_skip_chroma", 1, "transform_skip_chroma"),
    ("ts_sig_coeff_group", 3, "ts_sig_coeff_group"),
    ("ts_sig", 3, "ts_sig"),
    ("ts_res_sign", 6, "ts_res_sign"),
    ("ts_gt1", 4, "ts_gt1"),
    ("ts_par", 1, "ts_par"),
    ("ts_gt2", 5, "ts_gt2"),
    ("cclm_flag", 1, "cclm_flag"),
    ("cclm_model", 1, "cclm_model"),
    ("ibc_flag", 3, "ibc_flag"),
]
N_CTX = sum(n for (_f, n, _o) in UVG_CTX_LAYOUT)
CTX_BYTES = N_CTX * 6


def parse_trace(path: str):
    """Yield (kind, x, y, split_tree, tree_type, states) records.
    states: list of (state0, state1) per context in struct order."""
    data = open(path, "rb").read()
    i = 0
    out = []
    while i < len(data):
        if data[i:i + 2] not in (b"E ", b"S "):
            i += 1
            continue
        kind = chr(data[i])
        hdr = data[i + 2:i + 2 + 21].decode("latin1")
        # "%4d %4d %9d %d" -> x(4) sp y(4) sp split(9) sp tree(1)
        try:
            x = int(hdr[0:4]); y = int(hdr[5:9])
            split = int(hdr[10:19]); tree = int(hdr[20:21])
        except ValueError:
            i += 1
            continue
        blob = data[i + 23:i + 23 + CTX_BYTES]
        if len(blob) < CTX_BYTES:
            break
        states = [struct.unpack_from("<HH", blob, k * 6) for k in range(N_CTX)]
        out.append((kind, x, y, split, tree, states))
        i += 23 + CTX_BYTES
    return out


def our_snapshots(stream_path: str):
    """Decode the stream, snapshotting (x, y, tree_type, s0, s1) after
    every leaf CU (matching the reference's E-record points)."""
    from uvg266_jax.hls.coding_tree import CodingTreeReader
    from uvg266_jax.oracle import ref_decoder
    snaps = []
    orig = CodingTreeReader._decode_cu

    def wrapper(self, x, y, w, h, st, tree_type=0, **kw):
        cu = orig(self, x, y, w, h, st, tree_type, **kw)
        snaps.append((x, y, tree_type, list(self.dec.s0), list(self.dec.s1)))
        return cu

    CodingTreeReader._decode_cu = wrapper
    frames = None
    try:
        frames = ref_decoder.decode_stream(open(stream_path, "rb").read())
    except Exception as e:              # compare what we got up to the error
        print(f"decode raised: {e!r} (comparing {len(snaps)} snapshots)")
    finally:
        CodingTreeReader._decode_cu = orig
    return snaps, frames


def compare(stream: str, trace: str, max_report: int = 5) -> int:
    from uvg266_jax.bitstream.ctx_tables import OFF
    recs = [r for r in parse_trace(trace) if r[0] == "E"]
    snaps, _frames = our_snapshots(stream)
    print(f"reference E-records: {len(recs)}  our leaf snapshots: {len(snaps)}")
    n = min(len(recs), len(snaps))
    reported = 0
    for k in range(n):
        (_k, rx, ry, _sp, rtree, rstates) = recs[k]
        (ox, oy, otree, s0, s1) = snaps[k]
        pos_ok = (rx, ry) == (ox, oy)
        diffs = []
        off = 0
        for (fam, cnt, ours) in UVG_CTX_LAYOUT:
            if ours is not None:
                base = OFF[ours]
                for j in range(cnt):
                    r0, r1 = rstates[off + j]
                    if (s0[base + j], s1[base + j]) != (r0, r1):
                        diffs.append((fam, j, (r0, r1),
                                      (s0[base + j], s1[base + j])))
            off += cnt
        if not pos_ok or diffs:
            print(f"record {k}: ref ({rx},{ry}) tree {rtree} / "
                  f"ours ({ox},{oy}) tree {otree}")
            for d in diffs[:8]:
                print("   ctx diff:", d)
            reported += 1
            if reported >= max_report:
                return 1
    if reported == 0:
        print("all compared records match bit-exactly")
    return 0


if __name__ == "__main__":
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.exit(compare(sys.argv[1], sys.argv[2]))
