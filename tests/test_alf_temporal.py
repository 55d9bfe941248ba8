"""Encode-side temporal ALF APS reuse (reference: alf.c:78-102 APS pool).

A low-delay sequence with slowly varying content should transmit an ALF
APS on early frames and then *reuse* it: later AUs carry no ALF APS NAL
but still signal sh_alf_enabled with the pooled aps id, and the oracle
(decoding coefficients only from previously transmitted bits) must
reproduce the recon exactly.
"""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes, RefLists
from uvg266_jax.consts import NalType
from uvg266_jax.oracle.decoder import decode_au, split_nals


def _clip(w, h, n, seed=11):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    frames = []
    for t in range(n):
        y = np.clip(120 + 60 * np.sin((xx + 2 * t) / 13)
                    + 40 * np.cos(yy / 7)
                    + rng.normal(0, 9, (h, w)), 0, 255).astype(np.int32)
        u = np.clip(y[::2, ::2] * 0.45 + 30
                    + rng.normal(0, 3, (h // 2, w // 2)),
                    0, 255).astype(np.int32)
        v = np.clip(200 - y[::2, ::2] * 0.3
                    + rng.normal(0, 3, (h // 2, w // 2)),
                    0, 255).astype(np.int32)
        frames.append(FramePlanes(y, u, v))
    return frames


def _alf_aps_count(au: bytes) -> int:
    cnt = 0
    for nal in split_nals(au):
        if nal.type == NalType.PREFIX_APS_NUT:
            # aps_params_type is the first 3 bits of the RBSP
            if (nal.payload[0] >> 5) == 0:
                cnt += 1
    return cnt


def test_temporal_aps_reuse_lowdelay():
    n = 6
    frames = _clip(192, 128, n)
    cfg = Config(width=192, height=128, qp=30, intra_period=0,
                 gop_len=4, gop_lowdelay=True, alf_type=1)
    enc = Encoder(cfg)
    results = []
    for f in frames:
        results += enc.feed(f)
    results += enc.flush()
    assert len(results) == n

    aps_counts = [_alf_aps_count(au) for (au, *_r) in results]
    alf_on = [fs.alf is not None and fs.alf.luma_enabled
              for (_a, _r2, fs, _rl, _s) in results]
    # ALF must engage on this clip and at least one enabled frame must
    # reuse a pooled APS (no APS NAL of its own)
    assert any(alf_on), "ALF never enabled — clip/QP no longer suitable"
    reused = [i for i in range(n) if alf_on[i] and aps_counts[i] == 0]
    assert reused, f"no temporal APS reuse happened: {aps_counts=}"
    # a reuse frame signals the pooled id, not a fresh APS
    for i in reused:
        fs = results[i][2]
        assert not fs.alf.new_aps
        assert fs.alf.aps_id in {results[j][2].alf.aps_id
                                 for j in range(i) if alf_on[j]}

    # oracle round-trip with a persistent APS pool
    dec_dpb = {}
    aps_pool = {}
    for au, rec, fs, rl, _s in results:
        pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
        pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
        if fs.slicetype == 2:
            dec_dpb.clear()
        orl = RefLists(l0=[dec_dpb[q] for q in pocs0],
                       l1=[dec_dpb[q] for q in pocs1],
                       pocs0=pocs0, pocs1=pocs1)
        drec, info = decode_au(au, cfg, enc.ctrl, fs, refs=orl,
                               aps_pool=aps_pool)
        assert info["checksum_ok"], f"poc {fs.poc}"
        assert np.array_equal(drec.y, rec.y), f"poc {fs.poc}"
        dec_dpb[fs.poc] = drec


def test_temporal_aps_rate_win():
    """Reuse must not increase the total bitrate vs fresh-APS-per-frame
    (compare against a pool-disabled encode of the same clip)."""
    n = 5
    frames = _clip(192, 128, n, seed=3)
    cfg = Config(width=192, height=128, qp=30, intra_period=0,
                 gop_len=4, gop_lowdelay=True, alf_type=1)

    enc = Encoder(cfg)
    results = []
    for f in frames:
        results += enc.feed(f)
    results += enc.flush()
    bits_pool = sum(len(au) * 8 for (au, *_r) in results)

    # disable the pool: force every frame to design a fresh APS
    import uvg266_jax.control.alf as alf_mod
    orig = alf_mod.alf_search_frame

    def no_pool(src, rec, ctrl, lam, bitdepth=8, aps_pool=None):
        return orig(src, rec, ctrl, lam, bitdepth, aps_pool=None)

    alf_mod.alf_search_frame = no_pool
    try:
        enc2 = Encoder(cfg)
        results2 = []
        for f in frames:
            results2 += enc2.feed(f)
        results2 += enc2.flush()
        bits_fresh = sum(len(au) * 8 for (au, *_r) in results2)
    finally:
        alf_mod.alf_search_frame = orig
    assert bits_pool <= bits_fresh, (bits_pool, bits_fresh)


def test_idr_clears_pool():
    """Across an IDR, the first ALF frame must transmit a fresh APS."""
    n = 8
    frames = _clip(192, 128, n, seed=5)
    cfg = Config(width=192, height=128, qp=30, intra_period=4,
                 gop_len=4, gop_lowdelay=True, alf_type=1)
    enc = Encoder(cfg)
    results = []
    for f in frames:
        results += enc.feed(f)
    results += enc.flush()
    for au, _rec, fs, _rl, _s in results:
        if fs.num >= 4 and fs.alf is not None and fs.alf.luma_enabled:
            # frames 4.. are after the second IDR: the first enabled one
            # must carry its own APS (pool was cleared)
            assert fs.alf.new_aps or fs.num > 4
            break
