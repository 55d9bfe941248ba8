"""Golden tests for high-level syntax writers.

The golden byte strings below were captured from the reference encoder
(uvg266 built from /root/reference, run at default settings) so these tests
do not need the reference binary.  At matched configs our SPS/PPS must be
byte-identical and the slice header must be a byte prefix of the slice NAL.
"""
from uvg266_jax.bitstream.bitwriter import Bitstream
from uvg266_jax.cfg import make_config
from uvg266_jax.consts import NalType
from uvg266_jax.control.params import EncoderControl, FrameState
from uvg266_jax.hls.headers import (
    nal_write,
    write_pps,
    write_slice_header,
    write_sps,
)

# (width, height, wpp) -> (sps_hex, pps_hex) captured from reference uvg266
GOLDEN = {(64, 64, False): ('0079002b02690000030100000300000300820412000bb6084d8a2150c1101a0410014000000300400000064620',
                   '0081000041020898092880'),
 (320, 240, True): ('0079002b0269000003010000030000030028203c4e002ed82136288543044068104005000003000100000300191880',
                    '0081000014101e226024a2'),
 (832, 480, False): ('0079002b026900000301000003000003001a0807848002ed8213628854304406810400500000030010000003019188',
                     '008100000d0403c226024a20'),
 (1920, 1080, False): ('0079002b026900000301000003000003000f02004392000bb6084d8a2150c1101a0410014000000300400000064620',
                       '0081000007810021c898092880')}

SLICE_HDR_PREFIX = "0041c40fc0"  # IDR_N_LP defaults, QP 21 (frame 0)


def _capture(w, h, wpp):
    cfg = make_config(width=w, height=h, wpp=wpp)
    ctrl = EncoderControl(cfg)
    b = Bitstream()
    write_sps(b, ctrl)
    sps = bytes([0, 0x79]) + b.bytes()
    b = Bitstream()
    write_pps(b, ctrl)
    pps = bytes([0, 0x81]) + b.bytes()
    return sps, pps


def test_sps_pps_golden():
    for (w, h, wpp), (sps_hex, pps_hex) in GOLDEN.items():
        sps, pps = _capture(w, h, wpp)
        assert sps.hex() == sps_hex, (w, h, sps.hex())
        assert pps.hex() == pps_hex, (w, h, pps.hex())


def test_slice_header_prefix():
    cfg = make_config(width=64, height=64, wpp=False)
    ctrl = EncoderControl(cfg)
    fs = FrameState(num=0, poc=0, pictype=NalType.IDR_N_LP, qp=21)
    bs = Bitstream()
    nal_write(bs, NalType.IDR_N_LP, 0, False)
    write_slice_header(bs, ctrl, fs, None)
    assert bs.bytes().hex() == "000001" + SLICE_HDR_PREFIX


def test_chroma_qp_map_identityish():
    cfg = make_config(width=64, height=64)
    ctrl = EncoderControl(cfg)
    # default table: below 30 identity, compression above (VVC default-like)
    assert ctrl.get_chroma_qp(17) == 17
    assert ctrl.get_chroma_qp(26) == 26
    assert ctrl.get_chroma_qp(0) == 0
    assert ctrl.get_chroma_qp(63) <= 63


def test_vui_aud_pictiming_roundtrip():
    """VUI in the SPS (spec-complete; the reference's writer is
    upstream-disabled), AUD and pic-timing SEI NALs: the stream must
    still parse (header_parse skips VUI by its size field) and decode
    with the oracle."""
    import numpy as np
    from uvg266_jax.cfg import Config
    from uvg266_jax.control.encoder import Encoder, FramePlanes
    from uvg266_jax.hls.header_parse import parse_sps
    from uvg266_jax.oracle.decoder import (decode_au, split_nals,
                                           strip_emulation_prevention)
    from uvg266_jax.consts import NalType
    rng = np.random.default_rng(3)
    w = h = 64
    cfg = Config(width=w, height=h, qp=30, gop_len=0, intra_period=1,
                 wpp=False, aud_enable=True, vui_sar_width=4,
                 vui_sar_height=3, vui_overscan=1, vui_fullrange=1,
                 vui_frame_field_info=True)
    enc = Encoder(cfg)
    f = FramePlanes(rng.integers(0, 256, (h, w)).astype(np.int32),
                    rng.integers(0, 256, (h//2, w//2)).astype(np.int32),
                    rng.integers(0, 256, (h//2, w//2)).astype(np.int32))
    outs = enc.feed(f) + enc.flush()
    au, rec, fs, *_r = outs[0]
    nals = split_nals(au)
    types = [n.type for n in nals]
    assert NalType.AUD_NUT in types
    assert types.count(NalType.PREFIX_SEI_NUT) >= 1
    sps_nal = next(n for n in nals if n.type == NalType.SPS_NUT)
    from uvg266_jax.bitstream.cabac import BitstreamReader
    sps = parse_sps(BitstreamReader(
        strip_emulation_prevention(sps_nal.payload)))
    assert sps.width == w
    dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=[])
    assert info["checksum_ok"]
    np.testing.assert_array_equal(dec_rec.y, rec.y)
