"""Coding-tool combination matrix: every pair oracle round-trips.

The per-tool tests cover each feature in isolation; real encodes run
with several enabled at once, and the interactions (shared syntax
order, context state, recon feedback) are where mismatches hide.
"""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.oracle.decoder import decode_au


def _src(w, h, seed):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(120 + 60 * np.sin((xx + yy) / 13) + 40 * np.cos(xx / 7)
                + rng.normal(0, 8, (h, w)), 0, 255).astype(np.int32)
    u = np.clip(y[::2, ::2] * 0.45 + 30
                + rng.normal(0, 3, (h // 2, w // 2)), 0, 255).astype(np.int32)
    v = np.clip(200 - y[::2, ::2] * 0.3
                + rng.normal(0, 3, (h // 2, w // 2)), 0, 255).astype(np.int32)
    return FramePlanes(y, u, v)


COMBOS = [
    dict(rdoq_enable=True, cclm=1),
    dict(rdoq_enable=True, trskip_enable=True, trskip_max_size=3),
    dict(mip=True, lfnst=True),
    dict(cclm=1, jccr=1, mip=True),
    dict(alf_type=1, cclm=1),
    dict(tiles_width_count=2, rdoq_enable=True),
    dict(wpp=True, mip=True),
    dict(max_btt_depth=(1, 1, 1), trskip_enable=True, trskip_max_size=3),
    dict(lfnst=True, jccr=1),
    dict(input_bitdepth=10, cclm=1, mip=True),
    dict(scaling_list=2, max_btt_depth=(1, 1, 1)),
    dict(scaling_list=2, cclm=1, mip=True),
    dict(scaling_list=2, wpp=True),
    dict(max_btt_depth=(1, 1, 1), mrl=True, mip=True),
    dict(max_btt_depth=(1, 1, 1), wpp=True, cclm=1),
    # round-3 matrix unlocks (former EncoderControl guards)
    dict(lfnst=True, mts=1),
    dict(lfnst=True, cclm=1),
    dict(dep_quant=True, lfnst=True),
    dict(dep_quant=True, trskip_enable=True, trskip_max_size=3),
    dict(dep_quant=True, jccr=1, cclm=1),
    dict(dual_tree=True, jccr=1),
    dict(dual_tree=True, lfnst=True),
    dict(dual_tree=True, lfnst=True, jccr=1, cclm=1),
    dict(lfnst=True, mts=1, mip=True, mrl=True, cclm=1, jccr=1,
         rdoq_enable=True),
    dict(dep_quant=True, dual_tree=True, mts=1, jccr=1, cclm=1, mip=True,
         mrl=True, trskip_enable=True, trskip_max_size=3),  # ~veryslow
]


@pytest.mark.parametrize("extra", COMBOS,
                         ids=[",".join(f"{k}" for k in c) for c in COMBOS])
def test_combo_roundtrip(extra):
    bd = extra.get("input_bitdepth", 8)
    maxv = (1 << bd) - 1
    src = _src(192, 128, seed=sum(map(len, extra)) + 3)
    if bd == 10:
        src = FramePlanes(src.y * 4, src.u * 4, src.v * 4)
    cfg = Config(width=192, height=128, qp=30, intra_period=1, gop_len=0,
                 **extra)
    enc = Encoder(cfg)
    (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
    drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
    assert info["headers_ok"]
    assert info["checksum_ok"]
    assert np.array_equal(drec.y, rec.y)
    if rec.u is not None:
        assert np.array_equal(drec.u, rec.u)
        assert np.array_equal(drec.v, rec.v)


@pytest.mark.parametrize("extra", [
    dict(cclm=1, jccr=1),
    dict(rdoq_enable=True, trskip_enable=True, trskip_max_size=3),
    dict(mip=True),
])
def test_combo_inter_roundtrip(extra):
    cfg = Config(width=192, height=128, qp=32, **extra)
    enc = Encoder(cfg)
    for i in range(2):
        for au, rec, fs, rl, _s in enc.feed(_src(192, 128, 120 + i)) + enc.flush():
            drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
            assert info["checksum_ok"]
            assert np.array_equal(drec.y, rec.y)


def test_cli_presets_roundtrip(tmp_path):
    """CLI --preset end-to-end through main(): each preset encodes and
    passes the oracle (--verify asserts internally)."""
    import uvg266_jax.tools.encode as E
    src = _src(128, 96, seed=9)
    raw = tmp_path / "in.yuv"
    with open(raw, "wb") as f:
        for pl in (src.y, src.u, src.v):
            f.write(pl.astype(np.uint8).tobytes())
    for preset in ("ultrafast", "medium", "slow"):
        out = tmp_path / f"{preset}.vvc"
        rc = E.main(["--input", str(raw), "--input-res", "128x96",
                     "-q", "30", "-p", "1", "-o", str(out),
                     "--preset", preset, "--verify", "--no-psnr"])
        assert rc == 0
        assert out.stat().st_size > 0


def test_cli_preset_flag_override(tmp_path):
    """An explicit tool flag on top of a preset must change the stream
    (ultrafast has cclm off; --cclm turns it on)."""
    import uvg266_jax.tools.encode as E
    src = _src(128, 96, seed=9)
    raw = tmp_path / "in.yuv"
    with open(raw, "wb") as f:
        for pl in (src.y, src.u, src.v):
            f.write(pl.astype(np.uint8).tobytes())
    outs = {}
    for extra in ((), ("--cclm",)):
        out = tmp_path / f"o{len(extra)}.vvc"
        rc = E.main(["--input", str(raw), "--input-res", "128x96",
                     "-q", "30", "-p", "1", "-o", str(out),
                     "--preset", "ultrafast", "--verify", "--no-psnr",
                     *extra])
        assert rc == 0
        outs[extra] = out.read_bytes()
    assert outs[()] != outs[("--cclm",)]
