"""End-to-end low-delay P: encode IDR + P frames, oracle-decode the whole
stream with an independent DPB, bit-exact recon + checksum match."""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.consts import SliceType
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.oracle.decoder import decode_au


def lp_config(w, h, qp=30, **kw):
    base = dict(width=w, height=h, qp=qp, gop_len=4, gop_lowdelay=True,
                intra_period=64, ref_frames=1, sao_type=0, alf_type=0,
                deblock_enable=True, rdoq_enable=False,
                signhide_enable=True, dep_quant=False, wpp=False,
                tmvp_enable=False)
    base.update(kw)
    return Config(**base)


def moving_clip(w, h, n, seed=0):
    # static noise TEXTURE baked into the base plane: it rolls with the
    # global motion, so it is free for MC but expensive for intra — the
    # signal that separates a working inter path from a broken one
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base_y = np.clip(120 + 60 * np.sin(xx / 23.0) + 40 * np.cos(yy / 17.0)
                     + rng.integers(-20, 20, (h, w)), 0, 255)
    base_u = 128 + 30 * np.sin(xx[::2, ::2] / 19.0) \
        + 10 * np.cos(yy[::2, ::2] / 11.0)
    base_v = 128 + 30 * np.cos(yy[::2, ::2] / 13.0) \
        + 10 * np.sin(xx[::2, ::2] / 9.0)
    frames = []
    for t in range(n):
        # global motion of 4 px/frame horizontally, 2 vertically — even
        # so the chroma planes roll consistently (2, 1) and one MV
        # predicts all three planes (real convergence is testable)
        y = np.roll(np.roll(base_y, 4 * t, axis=1), 2 * t, axis=0) \
            .astype(np.int32)
        u = np.clip(np.roll(np.roll(base_u, 2 * t, axis=1), t, axis=0),
                    0, 255).astype(np.int32)
        v = np.clip(np.roll(np.roll(base_v, 2 * t, axis=1), t, axis=0),
                    0, 255).astype(np.int32)
        frames.append(FramePlanes(y, u, v))
    return frames


def run_lp(w, h, n_frames=3, qp=30, **kw):
    cfg = lp_config(w, h, qp, **kw)
    enc = Encoder(cfg)
    frames = moving_clip(w, h, n_frames, seed=w)

    dec_dpb = []
    stats = []
    for i, src in enumerate(frames):
        au, rec, fs, refs = enc.encode_frame(i, src)
        dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=dec_dpb)
        np.testing.assert_array_equal(dec_rec.y, rec.y,
                                      err_msg=f"frame {i} luma mismatch")
        np.testing.assert_array_equal(dec_rec.u, rec.u)
        np.testing.assert_array_equal(dec_rec.v, rec.v)
        assert info["checksum_ok"] is True, f"frame {i} checksum"
        if fs.slicetype == SliceType.I:
            dec_dpb = []
        dec_dpb.insert(0, dec_rec)
        del dec_dpb[max(1, cfg.ref_frames):]
        mse = ((rec.y[:h, :w] - src.y.astype(np.int64)) ** 2).mean()
        stats.append((len(au) * 8, 10 * np.log10(255 * 255 / max(mse, 1e-9)),
                      fs.slicetype))
    return stats


def test_lowdelay_p_128():
    stats = run_lp(128, 128, n_frames=3)
    # P frames must be much cheaper than the IDR on translating content
    assert stats[0][2] == SliceType.I
    assert stats[1][2] == SliceType.P
    assert stats[1][0] < stats[0][0] * 0.8, f"P not cheaper: {stats}"
    assert stats[2][0] < stats[0][0] * 0.5, f"P not converging: {stats}"


def test_lowdelay_p_nonaligned():
    run_lp(176, 144, n_frames=3, qp=32)


def test_lowdelay_p_no_deblock():
    run_lp(128, 64, n_frames=2, deblock_enable=False)


def test_lowdelay_p_with_sao():
    run_lp(128, 128, n_frames=3, sao_type=3)


def test_jax_frac_interp_matches_mc_luma():
    """The search-side JAX interpolator must match the golden MC exactly."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from uvg266_jax.ops.inter import fetch_extended_block, mc_luma
    from uvg266_jax.ops.me import make_frac_search_fn

    rng = np.random.default_rng(3)
    ref = rng.integers(0, 256, (64, 96)).astype(np.int32)
    w = h = 16
    x, y = 40, 24
    win = fetch_extended_block(ref, x, y, w, h, 5, 5, 5, 5)[None]
    blocks = rng.integers(0, 256, (1, h, w)).astype(np.int32)
    fn = jax.jit(make_frac_search_fn(w, h))
    _best, preds, _c = fn(win.astype(np.int32), blocks,
                          np.zeros(49, dtype=np.float32))
    preds = np.asarray(preds)
    for k in range(49):
        dxq, dyq = k % 7 - 3, k // 7 - 3
        exp = mc_luma(ref, x, y, w, h, (dxq * 4, dyq * 4))
        np.testing.assert_array_equal(preds[0, k], exp,
                                      err_msg=f"offset ({dxq},{dyq})")


def test_wpp_substreams():
    """WPP: per-row substreams + entry points + context inheritance."""
    stats = run_lp(192, 192, n_frames=2, qp=30, wpp=True, sao_type=3)
    assert len(stats) == 2


def test_gpb_b_slices_bipred():
    """Low-delay B (GPB): 2 refs, bipred, full B syntax round-trip."""
    stats = run_lp(192, 128, n_frames=4, qp=30, ref_frames=2, bipred=1)
    assert stats[1][2] == SliceType.B


def test_two_reference_frames_p():
    stats = run_lp(128, 128, n_frames=4, qp=30, ref_frames=2)
    assert len(stats) == 4


def test_random_access_gop8():
    """RA B-pyramid GOP8: reordering, future refs, bipred, oracle DPB."""
    from uvg266_jax.control.encoder import Encoder, RefLists

    w = h = 128
    cfg = lp_config(w, h, 30, gop_len=8, gop_lowdelay=False, ref_frames=4,
                    bipred=1, sao_type=3)
    enc = Encoder(cfg)
    frames = moving_clip(w, h, 9, seed=3)
    results = []
    for src in frames:
        results.extend(enc.feed(src))
    results.extend(enc.flush())
    assert [r[2].poc for r in results] == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    dec_dpb = {}
    for (au, rec, fs, rl, src) in results:
        pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
        pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
        orl = RefLists(l0=[dec_dpb[q] for q in pocs0],
                       l1=[dec_dpb[q] for q in pocs1],
                       pocs0=pocs0, pocs1=pocs1)
        dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=orl)
        np.testing.assert_array_equal(dec_rec.y, rec.y,
                                      err_msg=f"POC {fs.poc}")
        assert info["checksum_ok"] is True
        dec_dpb[fs.poc] = dec_rec


def test_tmvp_lowdelay_roundtrip():
    """TMVP on: AMVP temporal candidate active from POC 2, merge temporal
    candidate throughout; chained-oracle DPB carries its own motion."""
    run_lp(128, 128, n_frames=4, tmvp_enable=True)
    run_lp(192, 128, n_frames=4, qp=30, ref_frames=2, bipred=1,
           tmvp_enable=True)


def test_tmvp_random_access_roundtrip():
    """TMVP with future references (col_list=L1, mirror negation)."""
    from uvg266_jax.control.encoder import Encoder, RefLists

    w = h = 128
    cfg = lp_config(w, h, 30, gop_len=8, gop_lowdelay=False, ref_frames=4,
                    bipred=1, tmvp_enable=True)
    enc = Encoder(cfg)
    frames = moving_clip(w, h, 9, seed=5)
    results = []
    for src in frames:
        results.extend(enc.feed(src))
    results.extend(enc.flush())
    dec_dpb = {}
    saw_tmvp_frame = False
    for (au, rec, fs, rl, src) in results:
        pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
        pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
        orl = RefLists(l0=[dec_dpb[q] for q in pocs0],
                       l1=[dec_dpb[q] for q in pocs1],
                       pocs0=pocs0, pocs1=pocs1)
        dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=orl)
        np.testing.assert_array_equal(dec_rec.y, rec.y,
                                      err_msg=f"POC {fs.poc}")
        assert info["checksum_ok"] is True, fs.poc
        assert dec_rec.motion is not None
        dec_dpb[fs.poc] = dec_rec
        if pocs0 and dec_dpb[pocs0[0]].motion is not None \
                and (dec_dpb[pocs0[0]].motion.dir != 0).any():
            saw_tmvp_frame = True
    assert saw_tmvp_frame, "no frame had a motion-bearing collocated ref"


def test_round_mv_comp():
    """MV float-representation rounding: identity below 6 mantissa bits,
    monotone quantization above (inter.c:1106-1140)."""
    from uvg266_jax.control.inter_cand import round_mv_comp
    for v in range(-32, 33):
        assert round_mv_comp(v) == v, v
    # quantized region: error bounded by the exponent step
    for v in (37, 100, 1000, -1000, 4095, -4095, 131071, -131072):
        r = round_mv_comp(v)
        scale = max(0, (abs(v)).bit_length() - 6)
        assert abs(r - v) <= (1 << scale) // 2 + 1, (v, r)
    assert round_mv_comp(65) == 66  # round-to-nearest at scale 1


def test_mv_scaling_pocs():
    from uvg266_jax.control.inter_cand import apply_mv_scaling_pocs
    # same distance -> unchanged
    assert apply_mv_scaling_pocs(4, 2, 2, 0, (100, -64)) == (100, -64)
    # half distance -> halved
    mv = apply_mv_scaling_pocs(4, 3, 4, 2, (100, -64))
    assert mv == (50, -32), mv
    # opposite direction -> negated
    mv = apply_mv_scaling_pocs(4, 6, 4, 2, (100, -64))
    assert mv == (-100, 64), mv


def test_merge_skip_on_static_content():
    """Static content must code P frames as (almost) all skip CUs after
    the merge RD screening (zero-CBF merge -> skip)."""
    from uvg266_jax.hls.coding_tree import CodingTreeReader  # noqa: F401
    cfg = lp_config(128, 128, qp=30, tmvp_enable=True)
    enc = Encoder(cfg)
    rng = np.random.default_rng(2)
    y = np.clip(rng.normal(128, 40, (128, 128)), 0, 255).astype(np.int32)
    src = FramePlanes(y, (y[::2, ::2] // 2).astype(np.int32),
                      (y[::2, ::2] // 3).astype(np.int32))
    bits = []
    for i in range(3):
        au, rec, fs, refs = enc.encode_frame(i, src)
        bits.append(len(au) * 8)
    # a fully-skipped frame is a few hundred bits at most
    assert bits[1] < bits[0] * 0.05, bits
    assert bits[2] < bits[0] * 0.05, bits


def test_rate_control_converges():
    from uvg266_jax.control.encoder import Encoder
    w, h = 192, 128
    target = 300000
    cfg = lp_config(w, h, 30, target_bitrate=target,
                    framerate_num=25, framerate_denom=1)
    enc = Encoder(cfg)
    frames = moving_clip(w, h, 16, seed=4)
    bits = 0
    for i, src in enumerate(frames):
        au, rec, fs, refs = enc.encode_frame(i, src)
        bits += len(au) * 8
    achieved = bits / (len(frames) / 25)
    assert 0.5 * target < achieved < 1.6 * target, achieved


def test_amvr_syntax_roundtrip():
    """AMVR signaling parity: imv flags emitted (quarter-pel selected,
    matching the reference writer, encode_coding_tree.c:1608)."""
    import numpy as np

    from uvg266_jax.cfg import Config
    from uvg266_jax.control.encoder import Encoder, FramePlanes
    from uvg266_jax.oracle.decoder import decode_au
    rng = np.random.default_rng(9)
    cfg = Config(width=192, height=128, qp=30, amvr=1)
    enc = Encoder(cfg)
    for i in range(2):
        y = np.clip(rng.normal(128, 40, (128, 192))
                    + np.arange(192) * 0.2, 0, 255).astype(np.int32)
        src = FramePlanes(y, (y[::2, ::2] // 2).astype(np.int32),
                          (y[::2, ::2] // 3).astype(np.int32))
        for au, rec, fs, rl, _s in enc.feed(src) + enc.flush():
            drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
            assert info["headers_ok"] and info["checksum_ok"]
