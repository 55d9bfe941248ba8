"""Long mixed-tool soak: multi-frame RA encode with many tools enabled,
every AU oracle-verified. Guards cross-feature interactions that the
pairwise combo matrix cannot see (DPB reuse, ALF temporal state, rate
control drift, GOP reordering with tool state)."""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.oracle.decoder import decode_au


def _clip(w, h, n, seed=3):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    base = 110 + 55 * np.sin(xx / 13) + 45 * np.cos(yy / 9)
    frames = []
    for i in range(n):
        # slow pan + noise: exercises inter prediction and RC adaptation
        y = np.clip(np.roll(base, i * 3, axis=1)
                    + rng.normal(0, 9, (h, w)), 0, 255).astype(np.int32)
        u = np.clip(y[::2, ::2] * 0.4 + 48
                    + rng.normal(0, 3, (h // 2, w // 2)), 0,
                    255).astype(np.int32)
        v = np.clip(215 - y[::2, ::2] * 0.3
                    + rng.normal(0, 3, (h // 2, w // 2)), 0,
                    255).astype(np.int32)
        frames.append(FramePlanes(y, u, v))
    return frames


@pytest.mark.parametrize("kw", [
    dict(gop_len=4, gop_lowdelay=True, alf_type=2, cclm=1, mip=True,
         rdoq_enable=True, max_btt_depth=(1, 1, 1)),
    dict(gop_len=8, gop_lowdelay=False, bipred=1, ref_frames=4,
         cclm=1, rdoq_enable=True, target_bitrate=600_000,
         rc_algorithm="oba"),
    dict(gop_len=4, gop_lowdelay=True, scaling_list=2, mrl=True,
         wpp=True),
], ids=["ld-alf-cclm-mip-rdoq-btt", "ra8-rc-oba-cclm-rdoq",
        "ld-scalinglist-mrl-wpp"])
def test_soak_mixed_tools(kw):
    n = 9
    frames = _clip(160, 96, n)
    cfg = Config(width=160, height=96, qp=32, intra_period=0, **kw)
    enc = Encoder(cfg)
    results = []
    for f in frames:
        results += enc.feed(f)
    results += enc.flush()
    assert len(results) == n
    dec_dpb = {}
    dec_aps = {}
    from uvg266_jax.control.encoder import RefLists
    for au, rec, fs, rl, _s in results:
        pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
        pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
        if fs.slicetype == 2:
            dec_dpb.clear()
        orl = RefLists(l0=[dec_dpb[q] for q in pocs0],
                       l1=[dec_dpb[q] for q in pocs1],
                       pocs0=pocs0, pocs1=pocs1)
        drec, info = decode_au(au, cfg, enc.ctrl, fs, refs=orl,
                               aps_pool=dec_aps)
        assert info["headers_ok"], f"poc {fs.poc}"
        assert info["checksum_ok"], f"poc {fs.poc}"
        assert np.array_equal(drec.y, rec.y), f"poc {fs.poc}"
        dec_dpb[fs.poc] = drec
