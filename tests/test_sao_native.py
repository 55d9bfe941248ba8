"""Native whole-frame SAO decision (sao.cpp rc_sao_search) vs the Python
sao_search_frame loop: identical per-CTU decisions."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import FramePlanes
from uvg266_jax.control.params import EncoderControl


def _cmp(w, h, seed, lam, mono=False, bitdepth=8):
    import uvg266_jax.control.sao as sao_mod
    from uvg266_jax.native import sao_search_native
    rng = np.random.default_rng(seed)
    mx = (1 << bitdepth) - 1
    cfg = Config(width=w, height=h, input_bitdepth=bitdepth,
                 input_format=0 if mono else 1)
    ctrl = EncoderControl(cfg)
    W, H = ctrl.in_width, ctrl.in_height

    def plane(shape):
        base = rng.integers(0, mx + 1, shape)
        return base.astype(np.int32)

    src = FramePlanes(plane((H, W)),
                      None if mono else plane((H // 2, W // 2)),
                      None if mono else plane((H // 2, W // 2)))
    # rec = src + correlated noise so offsets are nonzero
    def noisy(p):
        if p is None:
            return None
        return np.clip(p + rng.integers(-4, 5, p.shape), 0, mx) \
            .astype(np.int32)
    rec = FramePlanes(noisy(src.y), noisy(src.u), noisy(src.v))

    nat = sao_search_native(src, rec, ctrl, lam, bitdepth)
    # force the python path
    orig = sao_mod.sao_search_frame.__globals__
    import importlib
    import uvg266_jax.native as native_mod
    real = native_mod.sao_search_native
    try:
        del native_mod.sao_search_native
        py = sao_mod.sao_search_frame(src, rec, ctrl, lam, bitdepth)
    finally:
        native_mod.sao_search_native = real
    for (a_list, b_list) in zip(nat, py):
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            assert a.type == b.type, (i, a, b)
            assert a.eo_class == b.eo_class, (i, a, b)
            assert list(a.band_position) == list(b.band_position), (i, a, b)
            assert list(a.offsets) == list(b.offsets), (i, a, b)
            assert a.merge_left == b.merge_left, (i, a, b)
            assert a.merge_up == b.merge_up, (i, a, b)


def test_sao_native_matches_python():
    for seed in range(4):
        _cmp(128, 128, seed, lam=40.0 + 30 * seed)


def test_sao_native_nonaligned():
    _cmp(176, 144, 9, lam=85.0)


def test_sao_native_mono():
    _cmp(128, 64, 3, lam=60.0, mono=True)


def test_sao_native_10bit():
    _cmp(128, 64, 5, lam=120.0, bitdepth=10)
