"""Native (C++) entropy coder bindings via ctypes.

Compiles the C++ sources on demand with g++ and wraps them in a
NativeCabac class drop-in compatible with bitstream.cabac.Cabac
for the syntax writers. The Python engine remains the golden model;
byte-identical output is asserted in tests.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

from ..bitstream.cabac import init_contexts as py_init_contexts
from ..bitstream.ctx_tables import NUM_CTX, OFF

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "entropy.cpp"), os.path.join(_DIR, "recon.cpp"),
         os.path.join(_DIR, "deblock.cpp"), os.path.join(_DIR, "tree.cpp"),
         os.path.join(_DIR, "sao.cpp"), os.path.join(_DIR, "inter.cpp")]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_LIB = None


def _host_cpu() -> str:
    """CPU model name: -march=native code is only valid on this model."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def _lib_tag() -> str:
    """Library tag: source hash + compiler flags + host CPU model, so a
    library built with -march=native on another CPU is never loaded."""
    hasher = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            hasher.update(f.read())
    hasher.update(" ".join(_FLAGS).encode())
    hasher.update(_host_cpu().encode())
    return hasher.hexdigest()[:16]


def _build_lib() -> str:
    so_path = os.path.join(_DIR, f"_entropy_{_lib_tag()}.so")
    if not os.path.exists(so_path):
        # build under a private name, then rename: concurrent builds
        # (test workers) never load a half-written library
        tmp = f"{so_path}.{os.getpid()}.tmp"
        args = ["g++", *_FLAGS, "-o", tmp, *_SRCS]
        try:
            subprocess.check_call(args)
        except subprocess.CalledProcessError:
            # portable fallback if -march=native is rejected
            subprocess.check_call([a for a in args
                                   if a != "-march=native"])
        os.replace(tmp, so_path)
    return so_path


def get_lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build_lib())
        lib.ec_create.restype = ctypes.c_void_p
        for name, argt in [
            ("ec_free", [ctypes.c_void_p]),
            ("ec_set_contexts", [ctypes.c_void_p] + [ctypes.c_void_p] * 4
             + [ctypes.c_int]),
            ("ec_get_contexts", [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]),
            ("ec_set_offsets", [ctypes.c_void_p, ctypes.c_void_p]),
            ("ec_start", [ctypes.c_void_p, ctypes.c_int]),
            ("ec_bin", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]),
            ("ec_bin_ep", [ctypes.c_void_p, ctypes.c_int]),
            ("ec_bins_ep", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]),
            ("ec_trm", [ctypes.c_void_p, ctypes.c_int]),
            ("ec_finish", [ctypes.c_void_p]),
            ("ec_trunc_bin", [ctypes.c_void_p, ctypes.c_uint32,
                              ctypes.c_uint32]),
            ("ec_put", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]),
            ("ec_coeff_remain", [ctypes.c_void_p, ctypes.c_uint32,
                                 ctypes.c_int, ctypes.c_int]),
            ("ec_ep_ex_golomb", [ctypes.c_void_p, ctypes.c_uint32,
                                 ctypes.c_int]),
            ("ec_unary_max_ep", [ctypes.c_void_p, ctypes.c_uint32,
                                 ctypes.c_uint32]),
            ("ec_copy_bytes", [ctypes.c_void_p, ctypes.c_void_p]),
        ]:
            getattr(lib, name).argtypes = argt
            getattr(lib, name).restype = None
        lib.ec_create.argtypes = []
        lib.ec_num_bytes.argtypes = [ctypes.c_void_p]
        lib.ec_num_bytes.restype = ctypes.c_int64
        lib.ec_pending_bits.argtypes = [ctypes.c_void_p]
        lib.ec_pending_bits.restype = ctypes.c_int
        lib.ec_pending_data.argtypes = [ctypes.c_void_p]
        lib.ec_pending_data.restype = ctypes.c_uint32
        lib.ec_zerocount.argtypes = [ctypes.c_void_p]
        lib.ec_zerocount.restype = ctypes.c_int
        lib.ec_coeff_nxn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.ec_coeff_nxn.restype = ctypes.c_int32
        lib.rc_set_dct2.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.rc_set_dct2.restype = None
        lib.rc_recon_frame.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_void_p] * 4
        lib.rc_recon_frame.restype = None
        lib.rc_deblock_frame.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 14 \
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_int] + [ctypes.c_void_p] * 2
        lib.rc_deblock_frame.restype = None
        lib.rc_set_scan.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.rc_set_scan.restype = None
        lib.tw_set_offsets.argtypes = [ctypes.c_void_p]
        lib.tw_set_offsets.restype = None
        lib.tw_set_scan.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
        lib.tw_set_scan.restype = None
        lib.tw_write_intra_frame.argtypes = \
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 9 + [ctypes.c_int]
        lib.tw_write_intra_frame.restype = None
        lib.tw_write_intra_wpp.argtypes = \
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 9 + [ctypes.c_int]
        lib.tw_write_intra_wpp.restype = None
        lib.tw_write_frame.argtypes = \
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 9 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p] * 9 + [ctypes.c_int]
        lib.tw_write_frame.restype = None
        lib.rc_sao_stats.argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
        lib.rc_sao_stats.restype = None
        lib.rc_sao_apply.argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4 \
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.rc_sao_apply.restype = None
        lib.fi_finalize_frame.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2          # planes
            + [ctypes.c_void_p] * 3 + [ctypes.c_int]            # l0
            + [ctypes.c_void_p] * 3 + [ctypes.c_int]            # l1
            + [ctypes.c_void_p] * 2                             # pocs
            + [ctypes.c_void_p, ctypes.c_int]                   # uniq
            + [ctypes.c_void_p] * 3                             # refmaps
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6        # tmvp
            + [ctypes.c_int] * 9 + [ctypes.c_double]            # params
            + [ctypes.c_int] * 2                                # wpp, threads
            + [ctypes.c_void_p, ctypes.c_int]                   # in leaves
            + [ctypes.c_void_p] * 5                             # out + coeff
            + [ctypes.c_void_p] * 14                            # deblock maps
            + [ctypes.c_void_p] * 3)                            # motion field
        lib.fi_finalize_frame.restype = None
        lib.fi_me_frame.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_double, ctypes.c_int]
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 2)
        lib.fi_me_frame.restype = None
        lib.fi_host_screen.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_double]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p])
        lib.fi_host_screen.restype = None
        lib.rc_sao_search.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 6 + [ctypes.c_double] + [ctypes.c_void_p] * 9
        lib.rc_sao_search.restype = None
        # upload DCT2 matrices + scan tables once
        from ..ops.scan import cg_scan_table, coeff_scan_table
        from ..ops.tr_matrices import DCT2 as _DCT2_T, get_matrix
        for lg in (2, 3, 4, 5):
            m = np.ascontiguousarray(get_matrix(_DCT2_T, 1 << lg),
                                     dtype=np.int16)
            lib.rc_set_dct2(lg, m.ctypes.data)
            _DCT_KEEP.append(m)
            sq = np.ascontiguousarray(coeff_scan_table(lg, lg),
                                      dtype=np.int32)
            cg = np.ascontiguousarray(cg_scan_table(lg, lg), dtype=np.int32)
            lib.tw_set_scan(lg, sq.ctypes.data, cg.ctypes.data)
            _DCT_KEEP.append(sq)
            _DCT_KEEP.append(cg)
        # rect scans for sign hiding on BT/TT-shaped TUs
        for lw in (2, 3, 4, 5):
            for lh in (2, 3, 4, 5):
                sc = np.ascontiguousarray(coeff_scan_table(lw, lh),
                                          dtype=np.int32)
                lib.rc_set_scan(lw, lh, sc.ctypes.data)
                _DCT_KEEP.append(sc)
        toffs = np.array([OFF[n] for n in (
            "split_flag", "qt_split_flag", "mtt_vertical", "mtt_binary",
            "intra_luma_mpm_flag", "luma_planar", "chroma_pred",
            "qt_cbf_cb", "qt_cbf_cr", "qt_cbf_luma",
            "sao_merge_flag", "sao_type_idx",
            "cu_skip_flag", "cu_pred_mode", "cu_merge_flag_ext",
            "cu_merge_idx_ext", "inter_dir", "cu_ref_pic", "mvp_idx",
            "cu_qt_root_cbf", "imv_flag", "cu_mvd")], dtype=np.int32)
        lib.tw_set_offsets(toffs.ctypes.data)
        _DCT_KEEP.append(toffs)
        _LIB = lib
    return _LIB


_DCT_KEEP: list = []

_OFFSET_ORDER = [
    "sig_coeff_group",
    "sig_luma_0", "sig_luma_1", "sig_luma_2",
    "sig_chroma_0", "sig_chroma_1", "sig_chroma_2",
    "parity_luma", "parity_chroma",
    "gt1_luma", "gt1_chroma",
    "gt2_luma", "gt2_chroma",
    "last_x_luma", "last_x_chroma",
    "last_y_luma", "last_y_chroma",
]


class NativeCabac:
    """Drop-in Cabac replacement backed by the C++ engine.

    Produces its own escaped byte buffer; splice into an AU Bitstream with
    flush_into(). Only the encode-side interface is provided.
    """

    def __init__(self, zerocount: int = 0):
        self.lib = get_lib()
        self.h = self.lib.ec_create()
        self.lib.ec_start(self.h, zerocount)
        offs = np.array([OFF[n] for n in _OFFSET_ORDER], dtype=np.int32)
        self.lib.ec_set_offsets(self.h, offs.ctypes.data)
        self._offs_keep = offs

    def __del__(self):
        try:
            self.lib.ec_free(self.h)
        except Exception:
            pass

    def init_contexts(self, qp: int, slice_type: int) -> None:
        s0, s1, r0, r1 = py_init_contexts(qp, slice_type)
        self._rates = (list(r0), list(r1))
        s0a = np.asarray(s0, dtype=np.uint16)
        s1a = np.asarray(s1, dtype=np.uint16)
        r0a = np.asarray(r0, dtype=np.uint8)
        r1a = np.asarray(r1, dtype=np.uint8)
        self.lib.ec_set_contexts(self.h, s0a.ctypes.data, s1a.ctypes.data,
                                 r0a.ctypes.data, r1a.ctypes.data, NUM_CTX)

    def save_ctx(self):
        return self.get_context_states()

    def load_ctx(self, snap) -> None:
        s0, s1 = snap
        r = np.asarray(self._rates[0], dtype=np.uint8)
        r1 = np.asarray(self._rates[1], dtype=np.uint8)
        s0 = np.ascontiguousarray(s0, dtype=np.uint16)
        s1 = np.ascontiguousarray(s1, dtype=np.uint16)
        self.lib.ec_set_contexts(self.h, s0.ctypes.data, s1.ctypes.data,
                                 r.ctypes.data, r1.ctypes.data, NUM_CTX)

    def get_context_states(self):
        s0 = np.zeros(NUM_CTX, dtype=np.uint16)
        s1 = np.zeros(NUM_CTX, dtype=np.uint16)
        self.lib.ec_get_contexts(self.h, s0.ctypes.data, s1.ctypes.data)
        return s0, s1

    # --- Cabac-compatible surface ---------------------------------------
    def encode_bin(self, ctx: int, binval: int) -> None:
        self.lib.ec_bin(self.h, ctx, binval)

    def encode_bin_ep(self, binval: int) -> None:
        self.lib.ec_bin_ep(self.h, binval)

    def encode_bins_ep(self, binvals: int, num_bins: int) -> None:
        self.lib.ec_bins_ep(self.h, binvals, num_bins)

    def encode_bin_trm(self, binval: int) -> None:
        self.lib.ec_trm(self.h, binval)

    def encode_trunc_bin(self, value: int, max_value: int) -> None:
        self.lib.ec_trunc_bin(self.h, value, max_value)

    def finish(self) -> None:
        self.lib.ec_finish(self.h)

    def put(self, value: int, bits: int) -> None:
        self.lib.ec_put(self.h, value, bits)

    def write_coeff_remain(self, remainder: int, rice: int, cutoff: int) -> int:
        self.lib.ec_coeff_remain(self.h, remainder, rice, cutoff)
        return 0

    def write_ep_ex_golomb(self, symbol: int, count: int) -> int:
        self.lib.ec_ep_ex_golomb(self.h, symbol, count)
        return 0

    def write_unary_max_symbol_ep(self, symbol: int, max_symbol: int) -> None:
        self.lib.ec_unary_max_ep(self.h, symbol, max_symbol)

    def write_unary_max_symbol(self, ctx_base: int, symbol: int,
                               offset: int, max_symbol: int) -> None:
        # ctx-coded unary-max (uvg_cabac_write_unary_max_symbol) on top
        # of the native bin engine; used by the rare cu_qp_delta syntax
        if not max_symbol:
            return
        code_last = max_symbol > symbol
        self.encode_bin(ctx_base, 1 if symbol else 0)
        if not symbol:
            return
        while symbol > 1:
            symbol -= 1
            self.encode_bin(ctx_base + offset, 1)
        if code_last:
            self.encode_bin(ctx_base + offset, 0)

    def align_zero(self) -> None:
        pending = self.lib.ec_pending_bits(self.h)
        if pending:
            self.lib.ec_put(self.h, 0, 8 - pending)

    def coeff_nxn(self, coeff: np.ndarray, is_luma: bool,
                  dep_quant: bool, signhide: bool,
                  scan: np.ndarray, scan_cg: np.ndarray,
                  log2_cg_w: int, log2_cg_h: int) -> int:
        c = np.ascontiguousarray(coeff, dtype=np.int32)
        return self.lib.ec_coeff_nxn(
            self.h, c.ctypes.data, c.shape[1], c.shape[0],
            int(is_luma), int(dep_quant), int(signhide),
            scan.ctypes.data, scan_cg.ctypes.data, log2_cg_w, log2_cg_h)

    # --- output ----------------------------------------------------------
    def bytes(self) -> bytes:
        n = self.lib.ec_num_bytes(self.h)
        out = np.zeros(int(n), dtype=np.uint8)
        if n:
            self.lib.ec_copy_bytes(self.h, out.ctypes.data)
        return out.tobytes()

    @property
    def zerocount(self) -> int:
        return self.lib.ec_zerocount(self.h)

    def flush_into(self, bitstream) -> None:
        """Append the (byte-aligned, already-escaped) payload into a
        Python Bitstream in one bulk extend."""
        assert self.lib.ec_pending_bits(self.h) == 0
        assert bitstream.cur_bit == 0
        bitstream.buf.extend(self.bytes())
        bitstream.zerocount = self.zerocount


def recon_frame_native(rec, src, coded_mask: np.ndarray, leaves, qp: int,
                       qp_c: int, bitdepth: int = 8,
                       signhide: bool = False, packed: bool = False,
                       wpp: bool = False):
    """Reconstruct all intra CUs of a frame in coding order via C++.

    rec/src: FramePlanes-likes with contiguous int32 planes. leaves: list of
    objects with x, y, w, h, cu_mode. Returns (coeff slices dict list,
    cbf array [n,3]).
    """
    lib = get_lib()
    n = len(leaves)
    larr = np.empty((n, 6), dtype=np.int32)
    for i, lf in enumerate(leaves):
        larr[i] = (lf.x, lf.y, lf.w, lf.h, lf.cu_mode, lf.cu_mode)
    ysz = int((larr[:, 2] * larr[:, 3]).sum())
    csz = int(((larr[:, 2] >> 1) * (larr[:, 3] >> 1)).sum())
    coeff_y = np.zeros(ysz, dtype=np.int32)
    has_chroma = rec.u is not None
    coeff_u = np.zeros(max(csz, 1), dtype=np.int32)
    coeff_v = np.zeros(max(csz, 1), dtype=np.int32)
    cbf = np.zeros((n, 3), dtype=np.int32)
    mask_u8 = coded_mask.view(np.uint8)
    fh, fw = rec.y.shape

    def ptr(a):
        return a.ctypes.data if a is not None else None

    lib.rc_recon_frame(
        ptr(rec.y), ptr(rec.u), ptr(rec.v),
        ptr(src.y), ptr(src.u), ptr(src.v),
        mask_u8.ctypes.data, fw, fh, qp, qp_c, bitdepth,
        1 if signhide else 0, 1 if wpp else 0, larr.ctypes.data, n,
        coeff_y.ctypes.data, coeff_u.ctypes.data, coeff_v.ctypes.data,
        cbf.ctypes.data)

    if packed:
        return larr, cbf, coeff_y, coeff_u, coeff_v
    # slice out per-TU coefficient blocks (CUs above the 32x32 max TU are
    # implicit-split; cbf arrives bit-packed per TU, blocks consecutive in
    # raster TU order). Keys are (color, tx_i, ty_i).
    out = []
    oy = oc = 0
    for i, lf in enumerate(leaves):
        w, hh = int(larr[i, 2]), int(larr[i, 3])
        tn_x, tn_y = max(1, w // 32), max(1, hh // 32)
        tw, th = min(w, 32), min(hh, 32)
        d = {}
        t = 0
        for ty_i in range(tn_y):
            for tx_i in range(tn_x):
                if (cbf[i, 0] >> t) & 1:
                    d[(0, tx_i, ty_i)] = \
                        coeff_y[oy:oy + tw * th].reshape(th, tw).copy()
                oy += tw * th
                if has_chroma:
                    cw, chh = tw >> 1, th >> 1
                    if (cbf[i, 1] >> t) & 1:
                        d[(1, tx_i, ty_i)] = \
                            coeff_u[oc:oc + cw * chh].reshape(chh, cw).copy()
                    if (cbf[i, 2] >> t) & 1:
                        d[(2, tx_i, ty_i)] = \
                            coeff_v[oc:oc + cw * chh].reshape(chh, cw).copy()
                    oc += cw * chh
                t += 1
        out.append(d)
    return out, cbf


def reconstruct_intra_cu_native(cu, rec, coded_mask: np.ndarray,
                                qp_y: int, qp_c: int, bitdepth: int,
                                signhide: bool, wpp: bool, src) -> None:
    """Closed-loop recon of ONE plain intra CU (DCT2, no MIP/MRL/CCLM/
    LFNST/JCCR/LMCS) via rc_recon_frame with n=1: per-CU fast path for
    intra CUs inside inter frames (reference: intra_recon_cu,
    intra.c — the Python reconstruct_intra_cu stays the golden model).
    Fills cu.cbf/cu.coeffs exactly like the Python path and updates the
    recon planes + coded mask in place."""
    lib = get_lib()
    larr = np.array([[cu.x, cu.y, cu.w, cu.h, cu.intra_mode,
                      cu.intra_mode_chroma]], dtype=np.int32)
    w, h = cu.w, cu.h
    tn_x, tn_y = max(1, w // 32), max(1, h // 32)
    tw, th = min(w, 32), min(h, 32)
    coeff_y = np.zeros(w * h, dtype=np.int32)
    has_chroma = rec.u is not None
    csz = (w >> 1) * (h >> 1)
    coeff_u = np.zeros(max(csz, 1), dtype=np.int32)
    coeff_v = np.zeros(max(csz, 1), dtype=np.int32)
    cbf = np.zeros((1, 3), dtype=np.int32)
    fh, fw = rec.y.shape

    def ptr(a):
        return a.ctypes.data if a is not None else None

    lib.rc_recon_frame(
        ptr(rec.y), ptr(rec.u), ptr(rec.v),
        ptr(src.y), ptr(src.u), ptr(src.v),
        coded_mask.view(np.uint8).ctypes.data, fw, fh, qp_y, qp_c,
        bitdepth, 1 if signhide else 0, 1 if wpp else 0,
        larr.ctypes.data, 1,
        coeff_y.ctypes.data, coeff_u.ctypes.data, coeff_v.ctypes.data,
        cbf.ctypes.data)

    oy = oc = 0
    t = 0
    for ty_i in range(tn_y):
        for tx_i in range(tn_x):
            rel = (tx_i, ty_i)
            by = (cbf[0, 0] >> t) & 1
            cu.cbf[(0, *rel)] = by
            if by:
                cu.coeffs[(0, *rel)] = \
                    coeff_y[oy:oy + tw * th].reshape(th, tw).copy()
            oy += tw * th
            if has_chroma:
                cw, chh = tw >> 1, th >> 1
                for c, buf in ((1, coeff_u), (2, coeff_v)):
                    bc = (cbf[0, c] >> t) & 1
                    cu.cbf[(c, *rel)] = bc
                    if bc:
                        cu.coeffs[(c, *rel)] = \
                            buf[oc:oc + cw * chh].reshape(chh, cw).copy()
                oc += cw * chh
            t += 1


def sao_stats_native(src: np.ndarray, rec: np.ndarray, lcu: int, wl: int,
                     n_ctu: int, bitdepth: int):
    """(edge_cnt[4,n,5], edge_sum, band_cnt[n,32], band_sum) via C++."""
    lib = get_lib()
    H, W = rec.shape
    e_cnt = np.zeros((4, n_ctu, 5), dtype=np.int64)
    e_sum = np.zeros((4, n_ctu, 5), dtype=np.int64)
    b_cnt = np.zeros((n_ctu, 32), dtype=np.int64)
    b_sum = np.zeros((n_ctu, 32), dtype=np.int64)
    src = np.ascontiguousarray(src, dtype=np.int32)
    rec = np.ascontiguousarray(rec, dtype=np.int32)
    lib.rc_sao_stats(src.ctypes.data, rec.ctypes.data, W, H, lcu, wl,
                     n_ctu, bitdepth, e_cnt.ctypes.data, e_sum.ctypes.data,
                     b_cnt.ctypes.data, b_sum.ctypes.data)
    return e_cnt, e_sum, b_cnt, b_sum


def sao_apply_native(plane: np.ndarray, lcu: int, wl: int, bitdepth: int,
                     types: np.ndarray, eo_class: np.ndarray,
                     band_pos: np.ndarray, offsets: np.ndarray,
                     tile_boundaries=None) -> None:
    """In-place SAO apply for one plane via C++ (pre-SAO copy internal).

    tile_boundaries: optional (xs, ys) interior boundary coordinates in
    THIS plane's units — edge offsets never read across them."""
    lib = get_lib()
    H, W = plane.shape
    tbx = np.asarray((tile_boundaries or ((), ()))[0], dtype=np.int32)
    tby = np.asarray((tile_boundaries or ((), ()))[1], dtype=np.int32)
    pre = np.ascontiguousarray(plane, dtype=np.int32).copy()
    lib.rc_sao_apply(plane.ctypes.data, pre.ctypes.data, W, H, lcu, wl,
                     bitdepth, types.ctypes.data, eo_class.ctypes.data,
                     band_pos.ctypes.data, offsets.ctypes.data,
                     tbx.ctypes.data, len(tbx), tby.ctypes.data, len(tby))


def _pack_sao(ctrl, sao_luma, sao_chroma):
    """(ctypes arg list, keepalive tuple) for the tree writers' SAO args."""
    n_ctu = ctrl.width_in_lcu * ctrl.height_in_lcu
    if sao_luma is not None:
        t_l = np.array([s.type for s in sao_luma], dtype=np.int32)
        eo_l = np.array([s.eo_class for s in sao_luma], dtype=np.int32)
        bp_l = np.array([s.band_position for s in sao_luma],
                        dtype=np.int32).reshape(n_ctu, 2)
        off_l = np.array([s.offsets for s in sao_luma],
                         dtype=np.int32).reshape(n_ctu, 10)
        mrg = np.array([(s.merge_left, s.merge_up) for s in sao_luma],
                       dtype=np.int32).reshape(n_ctu, 2)
        if sao_chroma is not None and ctrl.chroma_format:
            t_c = np.array([s.type for s in sao_chroma], dtype=np.int32)
            eo_c = np.array([s.eo_class for s in sao_chroma], dtype=np.int32)
            bp_c = np.array([s.band_position for s in sao_chroma],
                            dtype=np.int32).reshape(n_ctu, 2)
            off_c = np.array([s.offsets for s in sao_chroma],
                             dtype=np.int32).reshape(n_ctu, 10)
        else:
            t_c = eo_c = bp_c = off_c = np.zeros(1, dtype=np.int32)
        args_sao = [t_l.ctypes.data, eo_l.ctypes.data, bp_l.ctypes.data,
                    off_l.ctypes.data, t_c.ctypes.data, eo_c.ctypes.data,
                    bp_c.ctypes.data, off_c.ctypes.data, mrg.ctypes.data]
        keep = (t_l, eo_l, bp_l, off_l, t_c, eo_c, bp_c, off_c, mrg)
    else:
        args_sao = [None] * 9
        keep = ()
    return args_sao, keep


def _tw_common_args(ctrl, cfg):
    slice_idx = 0    # I-slice (irap)
    return [ctrl.in_width, ctrl.in_height, 1 if ctrl.chroma_format else 0,
            1 if (cfg.signhide_enable and not cfg.dep_quant) else 0,
            1 if cfg.dep_quant else 0,
            cfg.min_qt_size[slice_idx], cfg.max_bt_size[slice_idx],
            cfg.max_tt_size[slice_idx], cfg.max_btt_depth[slice_idx]]


def write_intra_frame_native(cabac, larr: np.ndarray, cbf: np.ndarray,
                             coeff_y: np.ndarray, coeff_u, coeff_v,
                             ctrl, cfg, sao_luma, sao_chroma) -> None:
    """Emit SAO + coding-tree syntax for a whole all-intra frame through
    the C++ writer (tree.cpp), bit-exact with CodingTreeWriter."""
    from ..control.sao import abs_offset_max
    lib = get_lib()
    args_sao, keep = _pack_sao(ctrl, sao_luma, sao_chroma)
    lib.tw_write_intra_frame(
        cabac.h, larr.ctypes.data, len(larr), cbf.ctypes.data,
        coeff_y.ctypes.data, coeff_u.ctypes.data, coeff_v.ctypes.data,
        *_tw_common_args(ctrl, cfg),
        *args_sao, abs_offset_max(ctrl.bitdepth))


def write_intra_wpp_native(cabacs, larr: np.ndarray, cbf: np.ndarray,
                           coeff_y: np.ndarray, coeff_u, coeff_v,
                           ctrl, cfg, sao_luma, sao_chroma) -> None:
    """WPP variant: one NativeCabac per CTU row; tree.cpp inherits row
    contexts from the post-first-CTU state of the row above, bit-exact
    with the python per-row walk."""
    from ..control.sao import abs_offset_max
    lib = get_lib()
    args_sao, keep = _pack_sao(ctrl, sao_luma, sao_chroma)
    handles = (ctypes.c_void_p * len(cabacs))(
        *[c.h for c in cabacs])
    lib.tw_write_intra_wpp(
        handles, len(cabacs), larr.ctypes.data, len(larr), cbf.ctypes.data,
        coeff_y.ctypes.data, coeff_u.ctypes.data, coeff_v.ctypes.data,
        *_tw_common_args(ctrl, cfg),
        *args_sao, abs_offset_max(ctrl.bitdepth))
    del keep


def pack_frame_leaves(cus, has_chroma: bool = True):
    """Serialize finalized CuInfo leaves (coding order) into the flat
    arrays the C++ P/B-frame writer consumes: extended 20-int32 leaf
    records + per-leaf packed cbf bits + packed coefficient planes (every
    TU slot occupies space, zero-filled when its cbf is 0 — the same
    layout recon.cpp produces for the intra path)."""
    from ..consts import TR_MAX_WIDTH
    n = len(cus)
    larr = np.zeros((n, 20), dtype=np.int32)
    cbfs = np.zeros((n, 3), dtype=np.int32)
    total_y = sum(cu.w * cu.h for cu in cus)
    c_y = np.zeros(total_y, dtype=np.int32)
    total_c = total_y // 4 if has_chroma else 1
    c_u = np.zeros(total_c, dtype=np.int32)
    c_v = np.zeros(total_c, dtype=np.int32)
    off_y = off_c = 0
    for i, cu in enumerate(cus):
        r = larr[i]
        r[0], r[1], r[2], r[3] = cu.x, cu.y, cu.w, cu.h
        r[4] = cu.intra_mode
        r[5] = cu.intra_mode_chroma
        r[6] = cu.type
        r[7] = 1 if cu.skipped else 0
        r[8] = 1 if cu.merged else 0
        r[9] = cu.merge_idx
        r[10] = cu.mv_dir
        if cu.type == 2:
            if not cu.merged:       # merged CUs keep the flat default mvd
                r[11], r[12] = cu.mvd[0]
                r[13], r[14] = cu.mvd[1]
            mci = cu.mv_cand_idx
            if isinstance(mci, tuple):
                r[15], r[16] = mci
            else:
                r[15] = r[16] = mci
            r[17], r[18] = cu.mv_ref
        tn_x = max(1, cu.w // TR_MAX_WIDTH)
        tn_y = max(1, cu.h // TR_MAX_WIDTH)
        tw, th = min(cu.w, TR_MAX_WIDTH), min(cu.h, TR_MAX_WIDTH)
        t = 0
        for ty in range(tn_y):
            for tx in range(tn_x):
                for color in (0, 1, 2):
                    if cu.cbf.get((color, tx, ty)):
                        cbfs[i, color] |= 1 << t
                        co = cu.coeffs[(color, tx, ty)]
                        if color == 0:
                            c_y[off_y + t * tw * th:
                                off_y + (t + 1) * tw * th] = co.ravel()
                        else:
                            cw, ch = tw >> 1, th >> 1
                            dst = c_u if color == 1 else c_v
                            dst[off_c + t * cw * ch:
                                off_c + (t + 1) * cw * ch] = co.ravel()
                t += 1
        off_y += cu.w * cu.h
        if has_chroma:
            off_c += (cu.w * cu.h) >> 2
    return larr, cbfs, c_y, c_u, c_v


def write_frame_native(cabacs, row_mode: int, larr: np.ndarray,
                       cbf: np.ndarray, coeff_y: np.ndarray, coeff_u,
                       coeff_v, ctrl, cfg, sao_luma, sao_chroma,
                       is_intra_slice: bool, is_b: bool, num_ref,
                       fs_is_irap: bool = False) -> None:
    """Emit SAO + coding-tree syntax for a whole P/B (or intra) frame
    through the C++ writer (tree.cpp tw_write_frame), bit-exact with
    CodingTreeWriter. cabacs: [engine] for a single substream
    (row_mode=0) or one per CTU row (row_mode=1, WPP)."""
    from ..control.sao import abs_offset_max
    lib = get_lib()
    args_sao, keep = _pack_sao(ctrl, sao_luma, sao_chroma)
    handles = (ctypes.c_void_p * len(cabacs))(*[c.h for c in cabacs])
    slice_idx = 0 if fs_is_irap else 1
    lib.tw_write_frame(
        handles, len(cabacs), row_mode,
        larr.ctypes.data, len(larr), cbf.ctypes.data,
        coeff_y.ctypes.data, coeff_u.ctypes.data, coeff_v.ctypes.data,
        ctrl.in_width, ctrl.in_height, 1 if ctrl.chroma_format else 0,
        1 if (cfg.signhide_enable and not cfg.dep_quant) else 0,
        1 if cfg.dep_quant else 0,
        cfg.min_qt_size[slice_idx], cfg.max_bt_size[slice_idx],
        cfg.max_tt_size[slice_idx], cfg.max_btt_depth[slice_idx],
        1 if is_intra_slice else 0, 1 if is_b else 0,
        num_ref[0], num_ref[1], cfg.max_merge, 1 if cfg.amvr else 0,
        *args_sao, abs_offset_max(ctrl.bitdepth))
    del keep


def deblock_frame_native(rec, cus, qp: int, qp_c: int, beta_off2: int,
                         tc_off2: int, bitdepth: int = 8,
                         ref_pocs=None, packed=None,
                         tile_boundaries=None, cus_chroma=None,
                         _planes: int = 3, qp_map=None,
                         cqp_lut=None) -> None:
    """Apply the in-loop deblocking filter to reconstructed planes.

    cus: iterable of CuInfo-likes (x, y, w, h, type, cbf lookup via
    cbf_set). Shared by the encoder and the decoding oracle.
    cus_chroma: dual-tree I-slice chroma-tree CUs — chroma edges follow
    the CHROMA tree geometry/cbf (luma edges the luma tree); when given,
    the filter runs as a luma pass over `cus` and a chroma pass over
    `cus_chroma` (plane filters are independent, so the split preserves
    the spec's vertical-then-horizontal order per plane).
    packed: optional (larr [n,6], cbf [n,3]) all-intra fast path that
    builds the per-4x4 maps with grouped scatters instead of per-CU
    Python loops (the recon.cpp packed layout).
    tile_boundaries: optional (xs, ys) interior tile boundary coordinates
    in luma pixels — edges on them are left unfiltered
    (pps_loop_filter_across_tiles_enabled_flag == 0 semantics).
    """
    lib = get_lib()
    if packed is None:
        cus = list(cus)
        # ISP CUs have a finer LUMA TU grid than chroma (chroma stays one
        # CU-level TU): run separate luma/chroma passes so the shared
        # per-4x4 TU map can differ per plane (filter.c:837-857 treats ISP
        # sub-TU boundaries as edges for the matching direction)
        if cus_chroma is None and _planes == 3 \
                and any(getattr(cu, "isp_mode", 0) for cu in cus):
            cus_chroma = cus
    tbx = np.asarray((tile_boundaries or ((), ()))[0], dtype=np.int32)
    tby = np.asarray((tile_boundaries or ((), ()))[1], dtype=np.int32)
    tb_args = (tbx.ctypes.data, len(tbx), tby.ctypes.data, len(tby))
    fh, fw = rec.y.shape
    gw, gh = -(-fw // 4), -(-fh // 4)
    shape = (gh, gw)
    cu_x = np.zeros(shape, dtype=np.int32)
    cu_y = np.zeros(shape, dtype=np.int32)
    log2w = np.zeros(shape, dtype=np.int32)
    log2h = np.zeros(shape, dtype=np.int32)
    is_intra = np.zeros(shape, dtype=np.int32)
    cbf_y = np.zeros(shape, dtype=np.int32)
    cbf_u = np.zeros(shape, dtype=np.int32)
    cbf_v = np.zeros(shape, dtype=np.int32)
    if packed is not None:
        larr, cbfs = packed
        mvx = np.zeros(shape, dtype=np.int32)
        mvy = np.zeros(shape, dtype=np.int32)
        refp = np.full(shape, -1, dtype=np.int32)
        is_intra[:] = 0
        for (w_, h_) in {(int(w), int(h))
                         for w, h in zip(larr[:, 2], larr[:, 3])}:
            sel = (larr[:, 2] == w_) & (larr[:, 3] == h_)
            xs = larr[sel, 0] // 4
            ys = larr[sel, 1] // 4
            # TU tiling: edges follow transform blocks (32-sample max TU),
            # so grid origin/size are those of the containing TB, not the CU
            tw_, th_ = min(w_, 32), min(h_, 32)
            lw = tw_.bit_length() - 1
            lh = th_.bit_length() - 1
            dy = np.arange(h_ // 4)
            dx = np.arange(w_ // 4)
            yy = (ys[:, None, None] + dy[None, :, None])
            xx = (xs[:, None, None] + dx[None, None, :])
            cu_x[yy, xx] = larr[sel, 0][:, None, None] \
                + (dx[None, None, :] * 4 // tw_) * tw_
            cu_y[yy, xx] = larr[sel, 1][:, None, None] \
                + (dy[None, :, None] * 4 // th_) * th_
            log2w[yy, xx] = lw
            log2h[yy, xx] = lh
            is_intra[yy, xx] = 1
            cbf_y[yy, xx] = cbfs[sel, 0][:, None, None]
            cbf_u[yy, xx] = cbfs[sel, 1][:, None, None]
            cbf_v[yy, xx] = cbfs[sel, 2][:, None, None]
        lib.rc_deblock_frame(
            rec.y.ctypes.data if rec.y is not None else None,
            rec.u.ctypes.data if rec.u is not None else None,
            rec.v.ctypes.data if rec.v is not None else None,
            fw, fh, qp, qp_c, beta_off2, tc_off2, bitdepth,
            cu_x.ctypes.data, cu_y.ctypes.data, log2w.ctypes.data,
            log2h.ctypes.data, is_intra.ctypes.data, cbf_y.ctypes.data,
            cbf_u.ctypes.data, cbf_v.ctypes.data, mvx.ctypes.data,
            mvy.ctypes.data, mvx.ctypes.data, mvy.ctypes.data,
            refp.ctypes.data, refp.ctypes.data, *tb_args, 3, None, None)
        return
    mvx = np.zeros(shape, dtype=np.int32)
    mvy = np.zeros(shape, dtype=np.int32)
    mvx1 = np.zeros(shape, dtype=np.int32)
    mvy1 = np.zeros(shape, dtype=np.int32)
    refp0 = np.full(shape, -1, dtype=np.int32)
    refp1 = np.full(shape, -1, dtype=np.int32)
    rp = ref_pocs or [[], []]
    for cu in cus:
        # Deblock edges follow TRANSFORM blocks, not CUs: a CU wider/taller
        # than the 32-sample max TU splits implicitly (and chroma co-splits,
        # see reconstruct_intra_cu), creating interior edges the filter must
        # visit (filter.c edge grids walk TU boundaries). Tile the grid per
        # TU so tu-origin/size/cbf are per-TB.
        isp = getattr(cu, "isp_mode", 0)
        if isp and _planes != 2 and cus_chroma is not None:
            # luma pass of an ISP CU: TU rects follow the sub-partitions,
            # merged up to the 4-sample map granularity (narrower sub-TU
            # edges are off the 4-sample deblock grid per spec)
            from ..ops.isp import isp_tu_locs
            locs = isp_tu_locs(cu.x, cu.y, cu.w, cu.h, isp)
            merge = max(1, 4 // (locs[0][2] if isp == 2 else locs[0][3]))
            for i in range(0, len(locs), merge):
                x0, y0, tw_, th_ = locs[i]
                cbf = 0
                for j in range(i, min(i + merge, len(locs))):
                    cbf |= cu.cbf_set(0, j, -1)
                if isp == 2:
                    tw_ = min(tw_ * merge, cu.w)
                else:
                    th_ = min(th_ * merge, cu.h)
                ys, xs = y0 // 4, x0 // 4
                ye, xe = (y0 + th_) // 4, (x0 + tw_) // 4
                cu_x[ys:ye, xs:xe] = x0
                cu_y[ys:ye, xs:xe] = y0
                log2w[ys:ye, xs:xe] = tw_.bit_length() - 1
                log2h[ys:ye, xs:xe] = th_.bit_length() - 1
                is_intra[ys:ye, xs:xe] = 1
                cbf_y[ys:ye, xs:xe] = cbf
            continue
        if isp and _planes == 2:
            # chroma pass of an ISP CU: chroma stays ONE CU-level TB
            # (no 32-luma co-split — the chroma TB is at most 32 wide)
            tw_, th_ = cu.w, cu.h
        else:
            tw_, th_ = min(cu.w, 32), min(cu.h, 32)
        for tyi in range(cu.h // th_):
            for txi in range(cu.w // tw_):
                x0 = cu.x + txi * tw_
                y0 = cu.y + tyi * th_
                ys, xs = y0 // 4, x0 // 4
                ye, xe = (y0 + th_) // 4, (x0 + tw_) // 4
                cu_x[ys:ye, xs:xe] = x0
                cu_y[ys:ye, xs:xe] = y0
                log2w[ys:ye, xs:xe] = tw_.bit_length() - 1
                log2h[ys:ye, xs:xe] = th_.bit_length() - 1
                is_intra[ys:ye, xs:xe] = 1 if cu.type == 1 else 0
                cbf_y[ys:ye, xs:xe] = cu.cbf_set(0, txi, tyi)
                cbf_u[ys:ye, xs:xe] = cu.cbf_set(1, txi, tyi)
                cbf_v[ys:ye, xs:xe] = cu.cbf_set(2, txi, tyi)
        ys, xs = cu.y // 4, cu.x // 4
        ye, xe = (cu.y + cu.h) // 4, (cu.x + cu.w) // 4
        if cu.type != 1:
            if cu.mv_dir & 1:
                mvx[ys:ye, xs:xe] = cu.mv[0][0]
                mvy[ys:ye, xs:xe] = cu.mv[0][1]
                refp0[ys:ye, xs:xe] = rp[0][cu.mv_ref[0]] \
                    if rp[0] else cu.mv_ref[0]
            if cu.mv_dir & 2:
                mvx1[ys:ye, xs:xe] = cu.mv[1][0]
                mvy1[ys:ye, xs:xe] = cu.mv[1][1]
                refp1[ys:ye, xs:xe] = rp[1][cu.mv_ref[1]] \
                    if rp[1] else cu.mv_ref[1]

    def ptr(a):
        return a.ctypes.data if a is not None else None

    planes = 1 if cus_chroma is not None else _planes
    if qp_map is not None:
        qp_map = np.ascontiguousarray(qp_map, dtype=np.int32)
        cqp_lut = np.ascontiguousarray(cqp_lut, dtype=np.int32)
        qp_args = (qp_map.ctypes.data, cqp_lut.ctypes.data)
    else:
        qp_args = (None, None)
    lib.rc_deblock_frame(
        ptr(rec.y), ptr(rec.u), ptr(rec.v), fw, fh, qp, qp_c,
        beta_off2, tc_off2, bitdepth,
        cu_x.ctypes.data, cu_y.ctypes.data, log2w.ctypes.data,
        log2h.ctypes.data, is_intra.ctypes.data, cbf_y.ctypes.data,
        cbf_u.ctypes.data, cbf_v.ctypes.data, mvx.ctypes.data,
        mvy.ctypes.data, mvx1.ctypes.data, mvy1.ctypes.data,
        refp0.ctypes.data, refp1.ctypes.data, *tb_args, planes, *qp_args)
    if cus_chroma is not None:
        # chroma pass over the chroma-tree CUs
        deblock_frame_native(rec, cus_chroma, qp, qp_c, beta_off2,
                             tc_off2, bitdepth, ref_pocs=ref_pocs,
                             tile_boundaries=tile_boundaries, _planes=2,
                             qp_map=qp_map, cqp_lut=cqp_lut)


def finalize_inter_frame_native(rec, src, coded_mask: np.ndarray, leaves,
                                rl, uniq, refmap, l1_index: dict,
                                tmvp, cur_poc: int,
                                qp_y: int, qp_c: int, bitdepth: int,
                                signhide: bool, is_b: bool,
                                bipred_enable: bool, max_merge: int,
                                num_ref_merge: int, parallel_log2: int,
                                lam: float, wpp: bool,
                                want_motion: bool, inl=None):
    """Whole-frame native finalize of a P/B frame (inter.cpp
    fi_finalize_frame): quarter-pel refine + merge/AMVP screening +
    closed-loop recon + HMVP/CuMap state in one C++ call, bit-exact with
    the Python _refine_inter_leaves + _finalize_sequential pair.

    leaves: coding-order CtuNode leaves with phase-1 cu_desc
    ({'type': 'intra', 'mode'} / {'type': 'inter', 'mv', 'list', 'ref',
    '_u' [, '_l0', '_l1']}).  Returns (packed, db_maps, motion) where
    packed = (larr20, cbfs, c_y, c_u, c_v) in the pack_frame_leaves
    layout, db_maps the 14 per-4x4 deblock arrays, motion a MotionField
    (or None).  Returns None when a desc shape is outside the native
    scope (caller falls back to the Python path)."""
    lib = get_lib()
    if inl is not None:
        n = len(inl)
    else:
        n = len(leaves)
        inl = np.zeros((n, 18), dtype=np.int32)
        for i, leaf in enumerate(leaves):
            d = leaf.cu_desc
            r = inl[i]
            r[0], r[1], r[2], r[3] = leaf.x, leaf.y, leaf.w, leaf.h
            t = d.get("type")
            if t == "intra":
                if d.get("mip") or d.get("tr_idx", 0):
                    return None
                r[4] = 0
                r[5] = d["mode"]
            elif t == "inter":
                if leaf.w > 32 or leaf.h > 32 or "_u" not in d:
                    return None
                r[4] = 1
                r[6] = d["_u"]
                r[7], r[8] = d["mv"]
                r[9] = d.get("list", 0)
                r[10] = d.get("ref", 0)
                if "_l0" in d:
                    r[11] = 1
                    u0, mv0 = d["_l0"]
                    u1, mv1 = d["_l1"]
                    r[12], (r[13], r[14]) = u0, mv0
                    r[15], (r[16], r[17]) = u1, mv1
            else:
                return None

    keep = []

    def plane_ptrs(planes, attr):
        arr = np.zeros(max(len(planes), 1), dtype=np.int64)
        for k, p in enumerate(planes):
            a = getattr(p, attr)
            assert a.dtype == np.int32 and a.flags.c_contiguous
            arr[k] = a.ctypes.data
            keep.append(a)
        keep.append(arr)
        return arr

    l0y = plane_ptrs(rl.l0, "y")
    l1y = plane_ptrs(rl.l1, "y")
    has_chroma = rec.u is not None
    if has_chroma:
        l0u = plane_ptrs(rl.l0, "u")
        l0v = plane_ptrs(rl.l0, "v")
        l1u = plane_ptrs(rl.l1, "u")
        l1v = plane_ptrs(rl.l1, "v")
    else:
        l0u = l0v = l1u = l1v = np.zeros(1, dtype=np.int64)
    pocs0 = np.asarray(list(rl.pocs0) or [0], dtype=np.int32)
    pocs1 = np.asarray(list(rl.pocs1) or [0], dtype=np.int32)

    uniq_y = np.zeros(max(len(uniq), 1), dtype=np.int64)
    for k, (_kid, p) in enumerate(uniq):
        assert p.y.dtype == np.int32 and p.y.flags.c_contiguous
        uniq_y[k] = p.y.ctypes.data
        keep.append(p.y)
    rm_list = np.asarray([l for (l, _r) in refmap] or [0], dtype=np.int32)
    rm_ref = np.asarray([r for (_l, r) in refmap] or [0], dtype=np.int32)
    l1i = np.zeros(max(len(uniq), 1), dtype=np.int32)
    for u, ridx in (l1_index or {}).items():
        l1i[u] = ridx

    if tmvp is not None:
        f = tmvp.col_field
        col_dir = np.ascontiguousarray(f.dir, dtype=np.int8)
        col_mv = np.ascontiguousarray(f.mv, dtype=np.int32)
        col_rp = np.ascontiguousarray(f.ref_poc, dtype=np.int32)
        col_h8, col_w8 = f.dir.shape
        tmvp_args = [col_dir.ctypes.data, col_mv.ctypes.data,
                     col_rp.ctypes.data, col_w8, col_h8,
                     int(tmvp.col_poc), int(cur_poc),
                     1 if tmvp.has_future_ref else 0, 1]
        keep += [col_dir, col_mv, col_rp]
    else:
        tmvp_args = [None, None, None, 0, 0, 0, int(cur_poc), 0, 0]

    fh, fw = rec.y.shape
    larr = np.zeros((n, 20), dtype=np.int32)
    cbfs = np.zeros((n, 3), dtype=np.int32)
    total_y = int((inl[:, 2].astype(np.int64) * inl[:, 3]).sum())
    c_y = np.zeros(total_y, dtype=np.int32)
    total_c = total_y // 4 if has_chroma else 1
    c_u = np.zeros(total_c, dtype=np.int32)
    c_v = np.zeros(total_c, dtype=np.int32)

    gh, gw = -(-fh // 4), -(-fw // 4)
    shape = (gh, gw)
    db = [np.zeros(shape, dtype=np.int32) for _ in range(12)]
    db += [np.full(shape, -1, dtype=np.int32) for _ in range(2)]
    # order: cux, cuy, l2w, l2h, intra, cbfy, cbfu, cbfv,
    #        mvx0, mvy0, mvx1, mvy1, rp0, rp1

    if want_motion:
        h8, w8 = (gh + 1) // 2, (gw + 1) // 2
        mf_dir = np.zeros((h8, w8), dtype=np.int8)
        mf_mv = np.zeros((h8, w8, 2, 2), dtype=np.int32)
        mf_rp = np.zeros((h8, w8, 2), dtype=np.int32)
        mf_args = [mf_dir.ctypes.data, mf_mv.ctypes.data, mf_rp.ctypes.data]
    else:
        mf_dir = mf_mv = mf_rp = None
        mf_args = [None, None, None]

    n_threads = min(os.cpu_count() or 1, 8)

    def ptr(a):
        return a.ctypes.data if a is not None else None

    lib.fi_finalize_frame(
        ptr(rec.y), ptr(rec.u), ptr(rec.v),
        ptr(src.y), ptr(src.u), ptr(src.v),
        coded_mask.view(np.uint8).ctypes.data, fw, fh,
        l0y.ctypes.data, l0u.ctypes.data, l0v.ctypes.data, len(rl.l0),
        l1y.ctypes.data, l1u.ctypes.data, l1v.ctypes.data, len(rl.l1),
        pocs0.ctypes.data, pocs1.ctypes.data,
        uniq_y.ctypes.data, len(uniq),
        rm_list.ctypes.data, rm_ref.ctypes.data, l1i.ctypes.data,
        *tmvp_args,
        qp_y, qp_c, bitdepth, 1 if signhide else 0,
        1 if is_b else 0, 1 if bipred_enable else 0, max_merge,
        num_ref_merge, parallel_log2, float(lam),
        1 if wpp else 0, n_threads,
        inl.ctypes.data, n,
        larr.ctypes.data, cbfs.ctypes.data,
        c_y.ctypes.data, c_u.ctypes.data, c_v.ctypes.data,
        *[a.ctypes.data for a in db],
        *mf_args)
    del keep

    motion = None
    if want_motion:
        from ..control.inter_cand import MotionField
        motion = MotionField(dir=mf_dir, mv=mf_mv, ref_poc=mf_rp)
    return (larr, cbfs, c_y, c_u, c_v), tuple(db), motion


def deblock_frame_maps_native(rec, maps, qp: int, qp_c: int, beta_off2: int,
                              tc_off2: int, bitdepth: int = 8) -> None:
    """Deblock with pre-built per-4x4 maps (the fi_finalize_frame
    outputs) — no per-CU Python work."""
    lib = get_lib()
    fh, fw = rec.y.shape
    tb = np.zeros(0, dtype=np.int32)

    def ptr(a):
        return a.ctypes.data if a is not None else None

    lib.rc_deblock_frame(
        ptr(rec.y), ptr(rec.u), ptr(rec.v), fw, fh, qp, qp_c,
        beta_off2, tc_off2, bitdepth,
        *[m.ctypes.data for m in maps],
        tb.ctypes.data, 0, tb.ctypes.data, 0, 3, None, None)


def me_frame_native(src_y: np.ndarray, uniq, prev_motion,
                    qp_scaled: int, bitdepth: int, lam: float,
                    me_range: int, wts, class_descs,
                    coarse: bool = False, u_lists=None,
                    is_b: bool = False):
    """Host full-pel ME (inter.cpp fi_me_frame): hexagon search with
    predictor seeding for every block of every class grid over every
    unique reference plane. Returns (mvs [R, total, 2] full-pel,
    costs [R, total] f32) with blocks packed per class in class_descs
    order (reference ME: search_inter.c:767 hexbs)."""
    lib = get_lib()
    keep = []
    uniq_y = np.zeros(max(len(uniq), 1), dtype=np.int64)
    for k, (_kid, p) in enumerate(uniq):
        uniq_y[k] = p.y.ctypes.data
        keep.append(p.y)
    cd = np.asarray(class_descs, dtype=np.int32).reshape(-1, 8)
    total = int((cd[:, 6].astype(np.int64) * cd[:, 7]).sum())
    R = len(uniq)
    out_mv = np.zeros((R, total, 2), dtype=np.int32)
    out_cost = np.zeros((R, total), dtype=np.float32)
    if prev_motion is not None:
        pf_dir = np.ascontiguousarray(prev_motion.dir, dtype=np.int8)
        pf_mv = np.ascontiguousarray(prev_motion.mv, dtype=np.int32)
        pf_h8, pf_w8 = pf_dir.shape
        pf_args = [pf_dir.ctypes.data, pf_mv.ctypes.data, pf_w8, pf_h8]
        keep += [pf_dir, pf_mv]
    else:
        pf_args = [None, None, 0, 0]
    wts = np.ascontiguousarray(wts, dtype=np.float32)
    fh, fw = src_y.shape
    n_threads = min(os.cpu_count() or 1, 8)
    if u_lists is not None:
        ul = np.ascontiguousarray(u_lists, dtype=np.int8)
    else:
        ul = np.zeros(max(R, 1), dtype=np.int8)
    keep.append(ul)
    lib.fi_me_frame(src_y.ctypes.data, fw, fh,
                    uniq_y.ctypes.data, R, *pf_args,
                    qp_scaled, bitdepth, float(lam), me_range,
                    int(coarse), ul.ctypes.data, int(is_b),
                    wts.ctypes.data, n_threads,
                    cd.ctypes.data, len(cd),
                    out_mv.ctypes.data, out_cost.ctypes.data)
    del keep
    return out_mv, out_cost


def host_screen_native(src_y: np.ndarray, qp_scaled: int, bitdepth: int,
                       lam: float, wts, mode_bits, class_descs):
    """Host intra screen for P/B frames (inter.cpp fi_host_screen):
    pseudo-recon + rough mode search per class block, same flat output
    layout as the device screen (per class [modes, costs]), so the
    low-delay pipeline can screen P/B frames without the device."""
    lib = get_lib()
    cd = np.asarray(class_descs, dtype=np.int32).reshape(-1, 8)
    total = int((cd[:, 6].astype(np.int64) * cd[:, 7]).sum())
    out = np.zeros(2 * total, dtype=np.float32)
    wts = np.ascontiguousarray(wts, dtype=np.float32)
    mb = np.ascontiguousarray(mode_bits, dtype=np.float32)
    src_y = np.ascontiguousarray(src_y, dtype=np.int32)
    fh, fw = src_y.shape
    n_threads = min(os.cpu_count() or 1, 8)
    lib.fi_host_screen(src_y.ctypes.data, fw, fh, qp_scaled, bitdepth,
                       float(lam), wts.ctypes.data, mb.ctypes.data,
                       cd.ctypes.data, len(cd), n_threads,
                       out.ctypes.data)
    return out


def sao_search_native(src_planes, rec_planes, ctrl, lam: float,
                      bitdepth: int = 8):
    """Whole-frame SAO decision in C++ (sao.cpp rc_sao_search),
    bit-exact with control/sao.py sao_search_frame (non-tiled configs).
    Returns (sao_luma, sao_chroma) SaoInfo lists in CTU raster order."""
    from ..consts import LCU_WIDTH
    from ..control.sao import SaoInfo
    lib = get_lib()
    wl, hl = ctrl.width_in_lcu, ctrl.height_in_lcu
    n = wl * hl
    fh, fw = rec_planes.y.shape
    t_l = np.zeros(n, dtype=np.int32)
    eo_l = np.zeros(n, dtype=np.int32)
    bp_l = np.zeros((n, 2), dtype=np.int32)
    off_l = np.zeros((n, 10), dtype=np.int32)
    t_c = np.zeros(n, dtype=np.int32)
    eo_c = np.zeros(n, dtype=np.int32)
    bp_c = np.zeros((n, 2), dtype=np.int32)
    off_c = np.zeros((n, 10), dtype=np.int32)
    mrg = np.zeros((n, 2), dtype=np.int32)
    has_chroma = rec_planes.u is not None

    def ptr(a):
        return a.ctypes.data if a is not None else None

    srcs = [np.ascontiguousarray(x, dtype=np.int32) if x is not None
            else None
            for x in (src_planes.y, src_planes.u, src_planes.v)]
    lib.rc_sao_search(
        ptr(srcs[0]), ptr(rec_planes.y), ptr(srcs[1]), ptr(rec_planes.u),
        ptr(srcs[2]), ptr(rec_planes.v),
        fw, fh, LCU_WIDTH, wl, hl, bitdepth, float(lam),
        t_l.ctypes.data, eo_l.ctypes.data, bp_l.ctypes.data,
        off_l.ctypes.data, t_c.ctypes.data, eo_c.ctypes.data,
        bp_c.ctypes.data, off_c.ctypes.data, mrg.ctypes.data)
    sao_luma = [SaoInfo(type=int(t_l[i]), eo_class=int(eo_l[i]),
                        band_position=[int(bp_l[i, 0]), int(bp_l[i, 1])],
                        offsets=[int(v) for v in off_l[i]],
                        merge_left=bool(mrg[i, 0]),
                        merge_up=bool(mrg[i, 1])) for i in range(n)]
    if has_chroma:
        sao_chroma = [SaoInfo(type=int(t_c[i]), eo_class=int(eo_c[i]),
                              band_position=[int(bp_c[i, 0]),
                                             int(bp_c[i, 1])],
                              offsets=[int(v) for v in off_c[i]],
                              merge_left=bool(mrg[i, 0]),
                              merge_up=bool(mrg[i, 1])) for i in range(n)]
    else:
        sao_chroma = [SaoInfo() for _ in range(n)]
    return sao_luma, sao_chroma
