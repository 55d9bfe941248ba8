"""Encoder configuration with uvg266-compatible option names and defaults.

Mirrors the behavior of the reference config system (cfg.c
uvg_config_init:51-246 for defaults, cfg.c:602-900 for presets) so that
matched settings produce comparable bitstreams.  Options irrelevant to
this design (threads, cpuid) are accepted but ignored.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from .consts import ChromaFormat


@dataclass
class Config:
    # --- input -----------------------------------------------------------
    width: int = 0
    height: int = 0
    framerate_num: int = 25
    framerate_denom: int = 1
    input_bitdepth: int = 8
    input_format: int = ChromaFormat.CSP_420

    # --- rate / qp --------------------------------------------------------
    qp: int = 22
    intra_qp_offset: int = 0
    intra_qp_offset_auto: bool = True
    target_bitrate: int = 0
    rc_algorithm: int = 0          # 0=no RC, 1=lambda-domain, 2=OBA
    intra_bit_allocation: bool = False
    vaq: int = 0

    # --- structure --------------------------------------------------------
    intra_period: int = 64
    vps_period: int = 0
    gop_len: int = 4
    # host-side intra screening for P/B frames (C++): removes the
    # per-frame device round-trip from the serial low-delay path
    host_intra_screen: bool = False
    gop_lowdelay: bool = True
    gop_lp_d: int = 3
    gop_lp_t: int = 1
    open_gop: bool = True
    ref_frames: int = 1
    bipred: int = 0
    tmvp_enable: bool = True

    # --- partitioning -----------------------------------------------------
    # [0]=intra luma, [1]=inter, [2]=intra chroma (dual tree)
    min_qt_size: tuple[int, int, int] = (4, 4, 4)
    max_btt_depth: tuple[int, int, int] = (0, 0, 0)
    max_bt_size: tuple[int, int, int] = (64, 64, 64)
    max_tt_size: tuple[int, int, int] = (64, 64, 64)
    dual_tree: int = 0
    pu_depth_intra: tuple[int, int] = (1, 3)   # (min, max) depth searched
    pu_depth_inter: tuple[int, int] = (2, 3)
    # two-stage rough+refine intra mode search (even angulars then +-1
    # around the top-2; search_intra.c rough search). RD-near-neutral;
    # off by default, the all-67 matmul predictor is the default path
    intra_rough: bool = False

    # --- tools ------------------------------------------------------------
    deblock_enable: bool = False
    deblock_beta: int = 0
    deblock_tc: int = 0
    sao_type: int = 3          # 0 off, 1 edge, 2 band, 3 full
    alf_type: int = 0          # 0 off, 1 no-cc, 2 full
    alf_info_in_ph_flag: bool = False
    lmcs_enable: bool = False
    rdoq_enable: bool = True
    rdoq_skip: bool = True
    signhide_enable: bool = True
    dep_quant: bool = False
    rdo: int = 1
    mts: int = 0               # 0 off, 1 intra, 2 inter, 3 both, 4 implicit
    mts_implicit: bool = False
    lfnst: bool = False
    isp: bool = False
    mrl: bool = False
    mip: bool = False
    cclm: int = 0
    jccr: int = 0
    amvr: int = 0
    ibc: int = 0
    trskip_enable: bool = False
    chroma_trskip_enable: bool = False
    trskip_max_size: int = 2
    scaling_list: int = 0      # 0 off, 1 custom (cqmfile), 2 default
    cqmfile: str | None = None
    implicit_rdpcm: bool = False
    lossless: bool = False
    intra_smoothing_disabled: bool = False
    intra_rough_search_levels: int = 2
    full_intra_search: bool = False
    zero_coeff_rdo: bool = True
    combine_intra_cus: bool = True
    intra_rdo_et: bool = False
    early_skip: bool = True
    me_early_termination: int = 1
    ime_algorithm: int = 0
    fme_level: int = 4
    me_max_steps: int = -1
    mv_rdo: int = 0
    mv_constraint: int = 0
    max_merge: int = 6
    log2_parallel_merge_level: int = 2
    ref_wraparound: int = 0
    scaling_list: int = 0
    fast_residual_cost_limit: int = 0

    # --- parallel ----------------------------------------------------------
    wpp: bool = True
    owf: int = -1
    tiles_width_count: int = 1
    tiles_height_count: int = 1
    tiles_width_split: tuple | None = None
    tiles_height_split: tuple | None = None
    slices: int = 0

    # --- output -------------------------------------------------------------
    aud_enable: bool = False
    stats_audit: bool = False   # per-frame est-vs-actual bits audit
    # VUI (cfg.c vui struct: --sar / --overscan / --videoformat range /
    # --frame-field-info; reference writer encoder_state-bitstream.c:346
    # exists but is never enabled upstream — here it is a real option)
    vui_sar_width: int = 0
    vui_sar_height: int = 0
    vui_overscan: int = 0            # 0 unspecified, 1 shown, 2 cropped
    vui_fullrange: int = 0
    vui_frame_field_info: bool = False
    add_encoder_info: bool = False   # version SEI (off: deterministic streams)
    calc_psnr: bool = True
    hash: int = 1            # 0 none, 1 checksum, 2 md5
    rc_algorithm: str = "lambda"   # "lambda" (R-lambda) or "oba"
    high_tier: bool = False
    level: int = 62
    force_level: bool = True
    source_scan_type: int = 0

    # chroma QP mapping table (identity by default, cfg.c:195-201)
    chroma_scale_in: tuple = (17, 27, 32, 44)
    chroma_scale_out: tuple = (17, 27, 32, 44)

    # --- derived (filled by finalize) ---------------------------------------
    def __post_init__(self):
        self.finalize()

    def finalize(self) -> None:
        pass

    # qp table signalling values (cfg.c parse_qp_map:453-467)
    @property
    def qp_table_start_minus26(self) -> int:
        return self.chroma_scale_in[0] - 26

    @property
    def qp_table_length_minus1(self) -> int:
        return len(self.chroma_scale_in) - 2

    @property
    def delta_qp_in_val_minus1(self) -> list[int]:
        ci = self.chroma_scale_in
        return [ci[i + 1] - ci[i] - 1 for i in range(len(ci) - 1)]

    @property
    def delta_qp_out_val(self) -> list[int]:
        co = self.chroma_scale_out
        return [co[i + 1] - co[i] for i in range(len(co) - 1)]


# --- presets ----------------------------------------------------------------
# Option sets applied on top of defaults; values mirror the preset table in
# the reference (cfg.c:602-900).  Only options this encoder understands are
# kept; scheduling options (owf/threads) are handled by the runtime.
PRESETS: dict[str, dict] = {
    "ultrafast": dict(
        rd=0, pu_depth_intra=(2, 3), pu_depth_inter=(1, 2), me="hexbs",
        ref_frames=1, deblock_enable=True, signhide_enable=False,
        subme=0, sao_type=0, rdoq_enable=False, rdoq_skip=False,
        transform_skip=False, mv_rdo=0, full_intra_search=False,
        smp=False, amp=False, cu_split_termination="zero", me_early_termination="sensitive",
        intra_rdo_et=False, early_skip=True, fast_residual_cost_limit=0,
        max_merge=6, cclm=0, jccr=0, mrl=False, mip=False, dual_tree=0,
        mts=0, isp=False, lfnst=False, dep_quant=False,
        max_btt_depth=(0, 0, 0),
    ),
    "superfast": dict(
        rd=0, pu_depth_intra=(2, 3), pu_depth_inter=(1, 2), me="hexbs",
        ref_frames=1, deblock_enable=True, signhide_enable=False,
        subme=2, sao_type=3, rdoq_enable=False, rdoq_skip=False,
        mts=0, isp=False, lfnst=False, dep_quant=False, max_btt_depth=(0, 0, 0),
    ),
    "veryfast": dict(
        rd=0, pu_depth_intra=(2, 3), pu_depth_inter=(1, 3), me="hexbs",
        ref_frames=1, deblock_enable=True, signhide_enable=False,
        subme=4, sao_type=3, rdoq_enable=False, rdoq_skip=False,
        mts=0, isp=False, lfnst=False, dep_quant=False, max_btt_depth=(0, 0, 0),
    ),
    "faster": dict(
        rd=0, pu_depth_intra=(2, 3), pu_depth_inter=(1, 3), me="hexbs",
        ref_frames=1, deblock_enable=True, signhide_enable=True,
        subme=4, sao_type=3, rdoq_enable=False, rdoq_skip=False,
        mts=0, isp=False, lfnst=False, dep_quant=False, max_btt_depth=(0, 0, 0),
    ),
    "fast": dict(
        rd=0, pu_depth_intra=(1, 3), pu_depth_inter=(1, 3), me="hexbs",
        ref_frames=2, deblock_enable=True, signhide_enable=True,
        subme=4, sao_type=3, rdoq_enable=True, rdoq_skip=True,
        mts=0, isp=False, lfnst=False, dep_quant=False, max_btt_depth=(0, 0, 0),
    ),
    "medium": dict(
        rd=0, pu_depth_intra=(1, 4), pu_depth_inter=(1, 3), me="hexbs",
        ref_frames=4, deblock_enable=True, signhide_enable=True,
        subme=4, sao_type=3, rdoq_enable=True, rdoq_skip=True,
        trskip_enable=False, mv_rdo=0, early_skip=True, max_merge=6,
        mts=0, isp=False, lfnst=False, dep_quant=False, max_btt_depth=(0, 0, 0),
    ),
    "slow": dict(
        rd=1, pu_depth_intra=(1, 4), pu_depth_inter=(1, 3), me="hexbs",
        ref_frames=4, deblock_enable=True, signhide_enable=True,
        subme=4, sao_type=3, rdoq_enable=True, rdoq_skip=True,
        mts=0, isp=False, lfnst=True, dep_quant=False, max_btt_depth=(1, 1, 1),
    ),
    "slower": dict(
        rd=2, pu_depth_intra=(1, 4), pu_depth_inter=(0, 3), me="tz",
        ref_frames=4, deblock_enable=True, signhide_enable=True,
        subme=4, sao_type=3, rdoq_enable=True, rdoq_skip=False,
        mts=3, isp=True, lfnst=True, dep_quant=True, max_btt_depth=(1, 1, 1),
        cclm=1, jccr=1, mrl=True, mip=True,
    ),
    "veryslow": dict(
        rd=2, pu_depth_intra=(1, 4), pu_depth_inter=(0, 3), me="tz",
        ref_frames=4, deblock_enable=True, signhide_enable=True,
        subme=4, sao_type=3, rdoq_enable=True, rdoq_skip=False,
        mts=3, isp=True, lfnst=True, dep_quant=True, max_btt_depth=(2, 2, 2),
        cclm=1, jccr=1, mrl=True, mip=True, dual_tree=1,
    ),
    "placebo": dict(
        rd=2, pu_depth_intra=(1, 4), pu_depth_inter=(0, 3), me="tz",
        ref_frames=4, deblock_enable=True, signhide_enable=True,
        subme=4, sao_type=3, rdoq_enable=True, rdoq_skip=False,
        mts=3, isp=True, lfnst=True, dep_quant=True, max_btt_depth=(3, 3, 3),
        cclm=1, jccr=1, mrl=True, mip=True, dual_tree=1,
    ),
}

_KNOWN = {f.name for f in dataclasses.fields(Config)}


def make_config(preset: str | None = None, **overrides) -> Config:
    cfg = Config()
    opts: dict = {}
    if preset:
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}")
        opts.update(PRESETS[preset])
    opts.update(overrides)
    for k, v in opts.items():
        if k in _KNOWN:
            setattr(cfg, k, v)
        # unknown/not-yet-mapped options are ignored (me, subme, rd, ...)
    cfg.finalize()
    return cfg
